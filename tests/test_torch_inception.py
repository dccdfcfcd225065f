"""The port's ``InceptionV3`` against the JAX package on the CPU in f32, in
both variants (pytorch-fid's FID blocks and torchvision's): pool3
features at batch 2 on 80-96 px inputs without resizing, and one case
resized to 299 by ``resize_input``; weights by ``from_jax`` (equal to
``to_torch`` key for key, loaded strictly), with seeded BatchNorm
statistics. A state_dict in the torchvision schema, with the ``fc.`` and
``AuxLogits.`` heads that the feature extractor does not own, loads
through ``utils.checkpoint.load_inception`` (the ``--fid_inception``
loader), bare or under ``state_dict``.

Tolerance: features within 1e-4 of their largest (about 90 convolutions
summed in other orders)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.models.inception import InceptionV3 as JInception
from stylegan_for_facerec_tpu.nn import Ctx
from stylegan_for_facerec_tpu.utils.torch_convert import to_torch
from stylegan_for_facerec_torch.models import InceptionV3
from stylegan_for_facerec_torch.utils.checkpoint import load_inception
from stylegan_for_facerec_torch.utils.convert import from_jax, load_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_bn(state, seed):
    """BatchNorm running statistics drawn from ``seed`` (the init's are
    the identity)."""
    rng = np.random.RandomState(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = jnp.asarray(0.1 * rng.randn(*v.shape), jnp.float32)
            else:
                out[k] = jnp.asarray(rng.uniform(0.5, 1.5, v.shape),
                                     jnp.float32)
        return out

    return walk(state)


@functools.lru_cache(maxsize=None)
def _init(fid):
    params, state = JInception(fid_variant=fid).init(jax.random.key(0))
    return fid, params, seeded_bn(state, 1)


@pytest.fixture(scope="module", params=[True, False], ids=["fid", "tv"])
def nets(request):
    return _init(request.param)


def test_from_jax_equals_to_torch(nets):
    fid, params, state = nets
    want = to_torch(JInception(fid_variant=fid), params, state)
    got = from_jax(InceptionV3(fid_variant=fid), params, state)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("Conv2d_1a_3x3.conv.weight",
              "Mixed_5b.branch1x1.bn.running_mean",
              "Mixed_7c.branch3x3dbl_3b.bn.weight"):
        assert k in got, k


def _features_match(nets, size, resize):
    fid, params, state = nets
    jm = JInception(fid_variant=fid, resize_input=resize)
    tm = load_from_jax(InceptionV3(fid_variant=fid, resize_input=resize),
                       params, state).eval()
    x = np.random.RandomState(size).uniform(
        -1, 1, (2, size, size, 3)).astype(np.float32)
    want, _ = jm.apply(params, state, jnp.asarray(x), Ctx(train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    want = np.asarray(want)
    assert got.shape == (2, 2048)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("size", [80, 96])
def test_features_match_jax(nets, size):
    _features_match(nets, size, resize=False)


def test_features_resized_to_299_match_jax():
    """64 px in, resized to 299 by the JAX package's bilinear matrices."""
    _features_match(_init(True), 64, resize=True)


@pytest.mark.parametrize("wrapped", [False, True])
def test_torchvision_schema_state_dict_loads(tmp_path, wrapped):
    """The port's state_dict plus torchvision's classifier heads, as a
    torchvision or pytorch-fid file has them: ``load_inception`` drops the
    heads and loads the rest strictly; a missing key still raises."""
    src = InceptionV3()
    gen = torch.Generator().manual_seed(2)
    sd = {k: torch.randn(v.shape, generator=gen) if v.is_floating_point()
          else v for k, v in src.state_dict().items()}
    full = dict(sd)
    full["fc.weight"], full["fc.bias"] = torch.zeros(1000, 2048), \
        torch.zeros(1000)
    full["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    path = tmp_path / "inception.pth"
    torch.save({"state_dict": full} if wrapped else full, path)
    dst = InceptionV3()
    load_inception(str(path), dst)
    for k, v in dst.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del full["Mixed_7c.branch_pool.conv.weight"]
    torch.save(full, path)
    with pytest.raises(RuntimeError, match="Missing"):
        load_inception(str(path), InceptionV3())
