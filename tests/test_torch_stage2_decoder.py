"""The port's stage-2 coach against the JAX package's with the decoder
trained (``train_decoder=True``): one step, on the CPU, in f32, in the
configuration and with the tolerances of ``test_torch_stage2.py``, whose
helpers it uses (one refinement iteration here, to keep the JAX compile
short)."""

import numpy as np

from test_torch_stage2 import (CFG, _check_updates,  # noqa: F401
                               _one_torch_thread, _run)


def test_train_decoder_matches_jax():
    """One step with the decoder trained. Two decoder tensors differ by
    design: ``noise_strength``'s gradient is the sum of noise x gradient
    over each framework's own random noise (checked: it moved and is
    finite), and the prologue ``const`` is centralised per channel of the
    port's (C, H, W) layout, as the reference torch Ranger does, where the
    JAX package centralises per row of its (H, W, C) layout: there the
    difference of the two updates must be a per-row plus a per-channel
    constant."""
    kw = dict(CFG, n_iters_per_batch=1, train_decoder=True)
    r = _run(kw, steps=1, seed=12)
    step, sd0 = r["steps"][0], r["sd0"]
    np.testing.assert_allclose(step["t_loss"], step["loss"], rtol=1e-4)
    const = "decoder.synthesis.first_block.const"
    noise = [k for k in sd0 if k.endswith("noise_strength")]
    n = _check_updates(sd0, step["sd"], step["t_sd"], "decoder.synthesis.",
                       skip=[const] + noise)
    assert n > 20
    _check_updates(sd0, step["sd"], step["t_sd"], "encoder.")
    for k in noise:
        assert np.isfinite(step["t_sd"][k]).all()
        assert not np.array_equal(step["t_sd"][k], sd0[k]), k
    d = (step["t_sd"][const] - sd0[const]) - (step["sd"][const] - sd0[const])
    resid = (d - d.mean(axis=(1, 2), keepdims=True)
             - d.mean(axis=(0, 2), keepdims=True) + d.mean())
    u = np.abs(step["sd"][const] - sd0[const]).max()
    assert np.abs(resid).max() <= 2e-3 * u + 8 * np.spacing(
        np.abs(sd0[const]).max())
    for k, v in sd0.items():
        if k.startswith("decoder.mapping."):
            np.testing.assert_array_equal(step["t_sd"][k], v, err_msg=k)
