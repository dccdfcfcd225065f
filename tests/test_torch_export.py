"""The port's ``torch.export`` serving artifacts (``utils/export.py``,
``tools/export_model.py``) and the four kernels as ``torch.library``
custom ops, on the CPU.

* ``torch.library.opcheck`` passes on ``sgfr::bias_act``,
  ``sgfr::bias_act_grad``, ``sgfr::smooth_upsample`` and
  ``sgfr::smooth_upsample_grad``: their CPU implementations (the plain
  versions), fake implementations, schemas and autograd registrations;
  and the ops' backwards are the ops (B1b for B1 and itself, B2b and B2
  for each other), differentiable to the second order.
* The embedder (a 4-unit ``PSpFaceRec`` at 32 px) exported with a
  symbolic batch, saved, loaded and run at batch 1 and 3 equals eager bit
  for bit (the same operations) and JAX's within 1e-4 of the output's
  scale (convolutions summed in another order).
* ``Generator(img_resolution=32)`` exported, saved and loaded keeps the
  B1/B2 custom-op nodes in its graph, equals eager bit for bit and JAX
  within 1e-4 of scale; the sidecar carries the JAX package's keys.
* ``export_model`` end to end on the CPU: a generator from a torch ADA
  ``.pt`` and a ``MobileFaceNet`` embedder from a JAX package checkpoint
  directory.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu import nn as jnn
from stylegan_for_facerec_tpu.models import stylegan2_ada as jada
from stylegan_for_facerec_tpu.utils.checkpoint import save_checkpoint
from stylegan_for_facerec_tpu.utils.torch_convert import from_torch
from stylegan_for_facerec_torch.models import psp
from stylegan_for_facerec_torch.models.mobilefacenet import MobileFaceNet
from stylegan_for_facerec_torch.models.stylegan2_ada import Generator
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.ops import fused_act, resample
from stylegan_for_facerec_torch.tools import export_model
from stylegan_for_facerec_torch.utils import export as ex
from stylegan_for_facerec_torch.utils.convert import load_from_jax
from test_torch_facerec_models import JTinyPSpFaceRec, perturbed, tiny_port

JAX_REL = 1e-4
SIDECAR_KEYS = {"fn_name", "platforms", "in_avals", "out_avals"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(*shape, seed=0, grad=False):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).requires_grad_(grad)


OPS = {
    "bias_act": lambda: (torch.ops.sgfr.bias_act.default,
                         (_rand(2, 4, 5, 6, grad=True),
                          _rand(4, seed=1, grad=True), "lrelu", 1.0, 0.5)),
    "bias_act_grad": lambda: (torch.ops.sgfr.bias_act_grad.default,
                              (_rand(2, 4, 5, 6, grad=True),
                               _rand(2, 4, 5, 6, seed=1), _rand(4, seed=2),
                               0.2, 2 ** 0.5, None)),
    "smooth_upsample": lambda: (torch.ops.sgfr.smooth_upsample.default,
                                (_rand(2, 3, 4, 5, grad=True),)),
    "smooth_upsample_grad": lambda: (
        torch.ops.sgfr.smooth_upsample_grad.default,
        (_rand(2, 3, 8, 10, grad=True),)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_custom_op_opcheck(name):
    op, args = OPS[name]()
    result = torch.library.opcheck(op, args)
    assert set(result.values()) == {"SUCCESS"}, result


def test_op_backwards_are_the_ops_to_second_order():
    x, b = _rand(2, 4, 5, 6, grad=True), _rand(4, seed=1, grad=True)
    y = fused_act.bias_act(x, b, clamp=0.5)
    g, = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    assert "bias_act_grad" in g.grad_fn.name()
    gg, = torch.autograd.grad(g.sum(), x)
    v = (x + b[:, None, None]).detach()
    slope = torch.where(v >= 0, 1.0, 0.2) * 2 ** 0.5
    mask = (torch.where(v >= 0, v, 0.2 * v) * 2 ** 0.5).abs() < 0.5
    # d/dx sum(dy * slope * mask) with dy = 2 y: 2 (slope mask)^2
    torch.testing.assert_close(gg, 2 * (slope * mask) ** 2, rtol=1e-6,
                               atol=1e-6)
    u = _rand(1, 2, 3, 3, grad=True)
    d, = torch.autograd.grad(resample.smooth_upsample(u).square().sum(), u,
                             create_graph=True)
    assert "smooth_upsample_grad" in d.grad_fn.name()
    dd, = torch.autograd.grad(d.sum(), u)
    assert torch.isfinite(dd).all()


def _sidecar(path):
    with open(path / ex.SIDECAR) as f:
        return json.load(f)


def test_embedder_round_trip_against_eager_and_jax(tmp_path):
    jm = JTinyPSpFaceRec(size=32, emb_size=64)
    params, state = perturbed(jm, 21)
    state["avg_image"] = np.random.RandomState(22).uniform(
        -1, 1, (32, 32, 3)).astype(np.float32)
    tm = psp.PSpFaceRec(size=32, emb_size=64)
    tiny_port(tm, tm.encoder)
    load_from_jax(tm, params, state).eval()
    ep = ex.export_embedder(tm, image_size=32, device="cpu")
    ex.save_exported(ep, str(tmp_path), metadata={"kind": "embedder"},
                     fn_name="embedder")
    meta = _sidecar(tmp_path)
    assert SIDECAR_KEYS | {"kind"} == set(meta)
    assert meta["in_avals"] == ["float32[b,32,32,3]"]
    assert meta["out_avals"] == ["float32[b,64]"]
    assert meta["platforms"] == ["cpu"]
    run = ex.load_exported(str(tmp_path)).module()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    for b in (1, 3):
        x = np.random.RandomState(b).uniform(-1, 1, (b, 32, 32, 3)).astype(
            np.float32)
        with torch.no_grad():
            got = run(torch.from_numpy(x))
            eager = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert torch.equal(got, eager)
        want = np.asarray(jm.apply(jparams, jstate, jnp.asarray(x),
                                   jnn.Ctx(train=False))[0])
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=JAX_REL * np.abs(want).max())


def _seeded_generator(seed=0):
    g = Generator(img_resolution=32)
    init_weights(g, torch.Generator().manual_seed(seed))
    return g.eval()


def test_generator_round_trip_keeps_the_kernel_ops(tmp_path):
    g = _seeded_generator()
    ep = ex.export_generator(g, device="cpu")
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert {"sgfr.bias_act.default",
            "sgfr.smooth_upsample.default"} <= targets
    ex.save_exported(ep, str(tmp_path), fn_name="generator")
    meta = _sidecar(tmp_path)
    assert set(meta) == SIDECAR_KEYS
    assert meta["in_avals"] == ["float32[b,512]"]
    assert meta["out_avals"] == ["float32[b,32,32,3]"]
    run = ex.load_exported(str(tmp_path)).module()
    z = np.random.RandomState(4).randn(3, 512).astype(np.float32)
    with torch.no_grad():
        got = run(torch.from_numpy(z))
        eager = g(torch.from_numpy(z), noise_mode="const").permute(0, 2, 3, 1)
    assert torch.equal(got, eager)
    jg = jada.Generator(img_resolution=32)
    params, state = from_torch(jg, {k: v.numpy()
                                    for k, v in g.state_dict().items()})
    want = np.asarray(jg.apply(params, state, jnp.asarray(z),
                               jnn.Ctx(train=False), noise_mode="const")[0])
    np.testing.assert_allclose(got.numpy(), want,
                               atol=JAX_REL * np.abs(want).max())
    with pytest.raises(ValueError, match="noise_mode"):
        ex.export_generator(g, noise_mode="random", device="cpu")


def test_export_model_cli_end_to_end(tmp_path):
    g = _seeded_generator(1)
    torch.save({"state_dict": {f"G.{k}": v for k, v in
                               g.state_dict().items()}}, tmp_path / "g.pt")
    export_model.main(["--kind", "generator", "--checkpoint",
                       str(tmp_path / "g.pt"), "--out", str(tmp_path / "gx"),
                       "--img_resolution", "32", "--device", "cpu"])
    assert _sidecar(tmp_path / "gx")["source"] == "torch ADA checkpoint"
    z = torch.randn(2, 512, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(
            ex.load_exported(str(tmp_path / "gx")).module()(z),
            g(z, noise_mode="const").permute(0, 2, 3, 1))

    from stylegan_for_facerec_tpu.models import mobilefacenet as jmfn
    jm = jmfn.MobileFaceNet(embedding_size=64)
    tm = MobileFaceNet(embedding_size=64)
    init_weights(tm, torch.Generator().manual_seed(3))
    params, state = from_torch(jm, {k: v.numpy()
                                    for k, v in tm.state_dict().items()})
    save_checkpoint(str(tmp_path / "run" / "step_000000001"),
                    {"params": {"backbone": params},
                     "state": {"backbone": state}})
    export_model.main(["--kind", "embedder", "--checkpoint",
                       str(tmp_path / "run"), "--out", str(tmp_path / "ex"),
                       "--backbone", "MobileFaceNet", "--emb_size", "64",
                       "--device", "cpu", "--batch", "2"])
    meta = _sidecar(tmp_path / "ex")
    assert meta["in_avals"] == ["float32[2,112,112,3]"]
    assert meta["source"] == "JAX package checkpoint"
    x = torch.rand(2, 112, 112, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        assert torch.equal(
            ex.load_exported(str(tmp_path / "ex")).module()(x),
            tm.eval()(x.permute(0, 3, 1, 2)))
