"""The port's stage-3 trainer with the zoo's backbones against the JAX
package's ``Stage3Trainer``, on the CPU in f32: one first step (the
"frozen" one: neither backbone has a ``body``, so both frameworks train
everything), 64-d embeddings, 64 classes, ArcFace + focal, SGD lr 0.03
momentum 0.9 weight decay 2e-3 (BatchNorm exempt), dropout 0.

  * ``MobileFaceNet`` with its head's depthwise conv at 2 x 2 (32 px
    input), batch 8, and ``ResNet`` with one bottleneck block a stage (the
    blocks and head of ``ResNet_50``) at 112 px, batch 4: the loss, every
    parameter's update and the BatchNorm statistics (the tolerances of
    ``tests/test_torch_stage3.py``: loss, top-1, top-5 1e-4 relative; an
    update within 2e-3 of that tensor's largest update plus 1e-6 of the
    largest update of any tensor and 4 f32 ulps of the parameter;
    statistics 1e-4 of scale);
  * ``ResNet_50`` itself at 112 px, batch 8: the loss, the statistics and
    the updates of the layers above its last ReLU (``bn_o1``, ``fc``,
    ``bn_o2`` and the class weight), at the same tolerances.

Why not every ``ResNet_50`` tensor, nor the 112 px MobileFaceNet: a train
step of either is chaotic in f32. Train-mode BatchNorm at batch 8 lets
one ReLU or PReLU input within rounding of 0 move a weight gradient by
10-30 % of its largest element; ``ResNet_50``'s steps and the 112 px
MobileFaceNet's differ at every batch seed tried, and against float64 the
port's and the JAX package's f32 steps are each as far off as from each
other (ROADMAP.md section C). The JAX package computes BatchNorm's batch
statistics in f32 even under x64, so a float64 comparison hits the same
flips. The smaller configurations above have none at batch seed 22.

Weights: the port trainer's (seed 0), then random BatchNorm affine and
statistics and PReLU slopes: ResNet's zero-init last BatchNorm weight
makes exact zeros meet ReLU, where ``jnp.maximum``'s gradient is 1/2 and
torch's (the reference's) 0 (``test_relu_gradient_at_zero_differs_from_
jax``). The JAX package's converter (``utils/torch_convert.py::
from_torch``) gives the JAX trainer the same backbone and head weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.models import mobilefacenet as jmfn
from stylegan_for_facerec_tpu.models import resnet as jres
from stylegan_for_facerec_tpu.train import Stage3Config as JConfig
from stylegan_for_facerec_tpu.train import Stage3Trainer as JTrainer
from stylegan_for_facerec_tpu.utils.torch_convert import from_torch
from stylegan_for_facerec_torch.models import mobilefacenet, resnet
from stylegan_for_facerec_torch.train.stage3 import (Stage3Config,
                                                     Stage3Trainer)
from stylegan_for_facerec_torch.utils.convert import from_jax
from test_torch_backbone_zoo import seeded
from test_torch_stage3 import _updates_close

CFG = dict(emb_size=64, num_classes=64, lr=0.03, momentum=0.9,
           weight_decay=2e-3, stages=(1,), freeze_backbone_epochs=1,
           compute_dtype="float32")
# name: (JAX model, port model, image size, batch, the parameters held;
# None: all)
MODELS = {
    "MobileFaceNet": (lambda: jmfn.MobileFaceNet(64, out_h=2, out_w=2),
                      lambda: mobilefacenet.MobileFaceNet(64, 2, 2), 32, 8,
                      None),
    "ResNet": (lambda: jres.ResNet(112, (1, 1, 1, 1), emb_size=64,
                                   drop_ratio=0.0),
               lambda: resnet.ResNet(112, (1, 1, 1, 1), emb_size=64,
                                     drop_ratio=0.0), 112, 4, None),
    "ResNet_50": (lambda: jres.ResNet_50(112, emb_size=64, drop_ratio=0.0),
                  lambda: resnet.ResNet_50(112, emb_size=64,
                                           drop_ratio=0.0), 112, 8,
                  ("backbone.bn_o1.", "backbone.fc.", "backbone.bn_o2.",
                   "head.")),
}
BATCH_SEED = 22


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sd(trainer):
    out = {f"backbone.{k}": v.detach().numpy().copy()
           for k, v in trainer.backbone.state_dict().items()}
    out["head.weight"] = trainer.head_weight.detach().numpy().copy()
    return out


def _batch(rng, size, n):
    """Images whose samples differ in colour and contrast, and labels."""
    x = rng.uniform(-0.7, 0.7, (n, 1, 1, 3)) + rng.uniform(
        -0.3, 0.3, (n, size, size, 3)) * rng.uniform(0.2, 1.0, (n, 1, 1, 1))
    return (np.clip(x, -1, 1).astype(np.float32),
            rng.randint(0, 64, n).astype(np.int32))


@pytest.fixture(scope="module", params=sorted(MODELS))
def run(request):
    jmake, tmake, size, n, held = MODELS[request.param]
    cfg = dict(CFG, batch_size=n)
    tt = Stage3Trainer(tmake(), Stage3Config(**cfg), steps_per_epoch=2,
                       device="cpu", seed=0)
    seeded(tt.backbone, 7).train()
    jm = jmake()
    p, s = from_torch(jm, {k: v.numpy() for k, v in
                           tt.backbone.state_dict().items()})
    jt = JTrainer(jm, JConfig(**cfg), steps_per_epoch=2)
    params = {"backbone": p, "head": {"weight": jnp.asarray(
        tt.head_weight.detach().numpy())}}
    opt = jt.tx.init(params)
    sd0 = _sd(tt)
    x, y = _batch(np.random.RandomState(BATCH_SEED), size, n)
    jmask = jt.freeze_mask(params, frozen=True)
    tmask = tt.freeze_mask(True)
    params, state, _, jmet = jt.train_step(
        params, {"backbone": s}, opt, jnp.asarray(x), jnp.asarray(y),
        jax.random.key(2), jnp.asarray(0), jmask)
    tmet = tt.train_step(torch.from_numpy(x), torch.from_numpy(y), 0, tmask)
    want = {f"backbone.{k}": v.numpy() for k, v in from_jax(
        tt.backbone, params["backbone"], state["backbone"]).items()}
    want["head.weight"] = np.asarray(params["head"]["weight"])
    names = [k for k, _ in tt.named_parameters()]
    if held is not None:
        names = [k for k in names if k.startswith(held)]
    return dict(sd0=sd0, want=want, got=_sd(tt), names=names,
                jm={k: float(v) for k, v in jmet.items()},
                tm={k: float(v) for k, v in tmet.items()},
                jmask=jmask, tmask=tmask)


def test_zoo_train_step_matches_jax(run):
    for k in ("loss", "top1", "top5"):
        np.testing.assert_allclose(run["tm"][k], run["jm"][k], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    _updates_close(run["sd0"], run["want"], run["got"], run["names"])
    want, got = run["want"], run["got"]
    n_stats = 0
    for k in want:
        if k.endswith("running_mean"):
            var = want[k[:-len("mean")] + "var"]
            for name, scale in ((k, np.sqrt(var.max())),
                                (k[:-len("mean")] + "var", var.max())):
                np.testing.assert_allclose(got[name], want[name], rtol=0,
                                           atol=1e-4 * scale, err_msg=name)
            n_stats += 1
    assert n_stats > 10


def test_frozen_epochs_train_everything_as_in_jax(run):
    """A ResNet or MobileFaceNet has no ``body``, so the frozen-epoch mask
    freezes nothing, in the JAX package and in the port; nearly every
    parameter moved over the "frozen" step."""
    jmask, tmask = run["jmask"], run["tmask"]
    assert all(float(v) == 1.0 for v in jax.tree_util.tree_leaves(jmask))
    assert all(tmask.values()) and len(tmask) == len(
        jax.tree_util.tree_leaves(jmask))
    sd0, got = run["sd0"], run["got"]
    moved = [k for k in tmask if not np.array_equal(got[k], sd0[k])]
    # a BatchNorm shift right before a train-mode BatchNorm has a zero
    # gradient by construction (and no weight decay): it may not move
    assert len(moved) >= 0.9 * len(tmask), (len(moved), len(tmask))


def test_relu_gradient_at_zero_differs_from_jax():
    """At an input of exactly 0, ``jnp.maximum(x, 0)`` passes half the
    gradient (JAX splits ties) and torch's ReLU none, as the reference's
    torch ResNet does; the port keeps torch's."""
    want = float(jax.grad(lambda x: jnp.maximum(x, 0.0))(0.0))
    x = torch.zeros((), requires_grad=True)
    torch.relu(x).backward()
    assert want == 0.5 and float(x.grad) == 0.0
