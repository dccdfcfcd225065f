"""Shared pieces of the stage-1 parity tests: the JAX stage-1 trainer's
draws for one D or G loss, made from its keys as ``_d_loss``/``_g_loss``
make them, in the port's layout (NCHW tensors)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stylegan_for_facerec_tpu.train.ada_aug import sample_ada_params
from stylegan_for_facerec_tpu.train.stage1 import Stage1Trainer as JTrainer
from stylegan_for_facerec_tpu.utils.config import Stage1Config as JConfig
from stylegan_for_facerec_torch.train.stage1 import Stage1Trainer
from stylegan_for_facerec_torch.utils.config import Stage1Config
from stylegan_for_facerec_torch.utils.convert import load_stage1_from_jax

SIZE, BATCH = 32, 4
ADA_P = 0.5


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def ada_params(prm) -> dict:
    """The JAX package's ``sample_ada_params`` draws as the port's: the
    noise field NHWC -> NCHW, everything else as it is."""
    out = {grp: {k: t(v) for k, v in d.items()} for grp, d in prm.items()}
    if "corrupt" in out:
        out["corrupt"]["noise"] = out["corrupt"]["noise"].permute(
            0, 3, 1, 2).contiguous()
    return out


def layer_noises(key, n, size=SIZE):
    """The i-th ``SynthesisLayer``'s noise in forward order: ``Ctx``'s
    ``make_rng`` folds 1, 2, ... into the key; (N, r, r, 1) -> (N, 1, r, r)."""
    res = [4]
    r = 8
    while r <= size:
        res += [r, r]
        r *= 2
    return [t(jax.random.normal(jax.random.fold_in(key, i + 1),
                                (n, r, r, 1))).permute(0, 3, 1, 2)
            for i, r in enumerate(res)]


def ada(key, n, p=ADA_P, size=SIZE):
    return ada_params(sample_ada_params(key, n, size, size, 3,
                                        jnp.asarray(p, jnp.float32)))


def d_draws(rng, z, p=ADA_P):
    k1, k2, k3 = jax.random.split(rng, 3)
    n = z.shape[0]
    return {"z": t(z), "noises": layer_noises(k1, n),
            "ada_real": ada(k2, n, p), "ada_fake": ada(k3, n, p)}


def g_draws(rng, z, p=ADA_P):
    k1, k2, k3 = jax.random.split(rng, 3)
    n = z.shape[0]
    half = max(1, n // 2)
    proj = jax.random.normal(k3, (half, SIZE, SIZE, 3)) / jnp.sqrt(
        SIZE * SIZE)
    return {"z": t(z), "noises": layer_noises(k1, n),
            "ada_fake": ada(k2, n, p),
            "pl_noises": layer_noises(k3, half),
            "pl_proj": t(proj).permute(0, 3, 1, 2).contiguous()}


def jax_trainer_and_state(seed=0):
    """The JAX trainer at 32 px, batch 4, and its init state with every
    synthesis layer's noise_strength, w_avg and pl_mean set away from 0,
    so the noise path, the EMA and pl_mean's update count."""
    jt = JTrainer(JConfig(image_size=SIZE, batch_size=BATCH))
    st = jt.init(jax.random.key(seed))
    rs = np.random.RandomState(seed + 100)

    def bump(tree):
        if isinstance(tree, dict):
            return {k: (jnp.asarray(rs.uniform(0.2, 0.6, (1,)), jnp.float32)
                        if k == "noise_strength" else bump(v))
                    for k, v in tree.items()}
        return tree

    st = dict(st)
    st["g"] = bump(st["g"])
    st["g_ema"] = st["g"]
    gs = dict(st["g_state"])
    gs["mapping"] = {"w_avg": jnp.asarray(
        rs.normal(0, 0.1, (512,)), jnp.float32)}
    st["g_state"] = gs
    st["pl_mean"] = jnp.asarray(0.3, jnp.float32)
    st["ada_p"] = jnp.asarray(ADA_P, jnp.float32)
    return jt, st


def port_trainer(jax_state) -> Stage1Trainer:
    tr = Stage1Trainer(Stage1Config(image_size=SIZE, batch_size=BATCH),
                       device="cpu")
    return load_stage1_from_jax(tr, jax_state)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
