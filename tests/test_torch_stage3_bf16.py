"""One bf16 stage-3 train step of the port against the JAX package's, on
the CPU, at the small shape of ``test_torch_stage3.py`` (4-unit
``PSpFaceRec`` at 32 px, 64 classes, ArcFace + focal, SGD, batch 8,
dropout off, one unfrozen step).

The two runs differ by design in where bf16 rounds: the JAX package casts
every backbone parameter to bf16, BatchNorm's affine included, and
normalises in bf16 (``stylegan_for_facerec_tpu/train/stage3.py``,
``cast_floats``); the port runs the backbone under autocast, so
convolutions and matmuls take bf16 operands while BatchNorm keeps f32
affine parameters and statistics. Both keep f32 master weights and run
the margin and the loss in f32. So they agree only to bf16's precision:
the bounds below are multiples of bf16's unit round-off (2^-8 = 3.9e-3),
and the test prints the measured deviations (``-s``): the f32 step of
the port, which ``test_torch_stage3.py`` holds against JAX's, is the
reference both approximate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.train import Stage3Config as JConfig
from stylegan_for_facerec_tpu.train import Stage3Trainer as JTrainer
from stylegan_for_facerec_torch.nn.layers import Dropout
from stylegan_for_facerec_torch.utils.convert import load_stage3_from_jax
from test_torch_facerec_models import JTinyPSpFaceRec
from test_torch_stage3 import CFG, _batch, _jax_sd, _sd, port_trainer

BF16_EPS = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def bf16_step():
    cfg = dict(CFG, compute_dtype="bfloat16")
    jt = JTrainer(JTinyPSpFaceRec(size=32, emb_size=64), JConfig(**cfg),
                  steps_per_epoch=2)
    params, state, opt = jt.init(jax.random.key(0))
    state["backbone"]["avg_image"] = jnp.asarray(np.random.RandomState(
        1).uniform(-1, 1, (32, 32, 3)).astype(np.float32))
    tt = port_trainer(compute_dtype="bfloat16")
    for m in tt.backbone.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    load_stage3_from_jax(tt, params, state)
    sd0 = _sd(tt)
    tt_state0 = {k: v.clone() for k, v in tt.backbone.state_dict().items()}
    x, y = _batch(22)
    params, state, opt, jm = jt.train_step(
        params, state, opt, jnp.asarray(x), jnp.asarray(y),
        jax.random.key(2), jnp.asarray(0), jt.freeze_mask(params,
                                                          frozen=False))
    tm = tt.train_step(torch.from_numpy(x), torch.from_numpy(y), 0,
                       tt.freeze_mask(False))
    want, got = _jax_sd(tt.backbone, params, state), _sd(tt)
    # the same step in f32 (the port's, which test_torch_stage3.py holds
    # against JAX's f32 step): the reference both bf16 steps approximate
    t32 = port_trainer()
    for m in t32.backbone.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    t32.backbone.load_state_dict(tt_state0)
    with torch.no_grad():
        t32.head_weight.copy_(torch.from_numpy(sd0["head.weight"]))
    t32.train_step(torch.from_numpy(x), torch.from_numpy(y), 0,
                   t32.freeze_mask(False))
    ref = _sd(t32)
    names = [k for k, _ in tt.named_parameters()]

    def dist(a, b):
        """All updates' norm of difference over the norm of b's."""
        num = sum(np.sum(np.square(a[k] - b[k])) for k in names)
        den = sum(np.sum(np.square(b[k] - sd0[k])) for k in names)
        return float(np.sqrt(num / den))

    out = {"port_vs_jax": dist(got, want), "port_vs_f32": dist(got, ref),
           "jax_vs_f32": dist(want, ref),
           "loss_rel": abs(float(tm["loss"]) - float(jm["loss"]))
           / float(jm["loss"]), "tm": tm, "jm": jm}
    print(f"\nbf16 stage-3 step: loss port {float(tm['loss']):.6f} JAX "
          f"{float(jm['loss']):.6f} (rel {out['loss_rel']:.3e}); updates "
          + ", ".join(f"{k} {v:.3e}" for k, v in out.items()
                      if k.endswith(("jax", "f32"))) + " in norm")
    return out


def test_bf16_step_loss_agrees_to_bf16_precision(bf16_step):
    assert bf16_step["loss_rel"] <= 4 * BF16_EPS, bf16_step["loss_rel"]
    assert bf16_step["tm"]["top1"] == pytest.approx(bf16_step["jm"]["top1"])


def test_bf16_step_updates_agree_to_bf16_precision(bf16_step):
    """Both bf16 steps sit about as far from the f32 step as from each
    other (measured: port 5.93e-2, JAX 6.08e-2, port vs JAX 5.96e-2 in
    norm, ~15 units of bf16 round-off): the gap is bf16 round-off through
    a net at batch 8, not the BatchNorm cast. Held: each within 32 units
    of the f32 step, and the port no further from it than 1.5 times the
    JAX step."""
    f32_port, f32_jax = bf16_step["port_vs_f32"], bf16_step["jax_vs_f32"]
    assert max(f32_port, f32_jax) <= 32 * BF16_EPS, bf16_step
    assert f32_port <= 1.5 * f32_jax, bf16_step
    assert bf16_step["port_vs_jax"] <= 32 * BF16_EPS, bf16_step
