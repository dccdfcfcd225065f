"""The port covers the JAX package's public API, read with ``ast`` alone
(no imports): every public top-level function and class of each module of
``stylegan_for_facerec_tpu/`` has a same-named counterpart in the module
at the same relative path under ``stylegan_for_facerec_torch/``, and every
root ``tools/*.py`` CLI a twin under ``stylegan_for_facerec_torch/tools/``
with the same public names, or an entry in ``JAX_ONLY`` that says why it
has none. An entry is a module (``path``) or a symbol (``path::name``)."""

import ast
import os

import pytest

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
JAX_PKG = os.path.join(REPO, "stylegan_for_facerec_tpu")
PORT_PKG = os.path.join(REPO, "stylegan_for_facerec_torch")

_FUNCTIONAL = "JAX idiom: the functional nn layer stack; torch.nn is its " \
              "counterpart"
_PALLAS = "a Pallas wrapper or its unfused XLA oracle; the port's kernels " \
          "are the CUDA ops in ops/fused_act.py and ops/resample.py, each " \
          "beside its plain version"
_OPTAX = "an optax transformation; the port's optimizers are torch.optim " \
         "classes (train/optim.py: Ranger, RAdam, sgd_param_groups)"
_SHARDING = "a jax.sharding placement helper; the port places data by " \
            "rank (parallel/mesh.py: Mesh, Axis)"
_MTCNN = "the functional MTCNN net forward; the port's PNet/RNet/ONet " \
         "modules' forward"
_REFERENCE = "out of scope: needs the upstream torch tree, absent here"

JAX_ONLY = {
    "nn/core.py": "JAX idiom: the functional Layer base (init/apply over "
                  "param trees); torch.nn.Module is its counterpart",
    "nn/initializers.py::kaiming_uniform": _FUNCTIONAL
    + " (nn/initializers.py: kaiming_uniform_, in place)",
    "nn/initializers.py::normal": _FUNCTIONAL + " (normal_)",
    "nn/initializers.py::uniform_fanin_bias": _FUNCTIONAL
    + " (uniform_fanin_bias_)",
    "nn/initializers.py::xavier_uniform": _FUNCTIONAL + " (xavier_uniform_)",
    **{f"nn/layers.py::{name}": _FUNCTIONAL for name in (
        "AdaptiveAvgPool2d", "AvgPool2d", "BatchNorm", "Conv2d",
        "GlobalAvgPool", "LeakyReLU", "Linear", "MaxPool2d", "PReLU", "ReLU",
        "Sigmoid")},
    "ops/upfirdn_pallas.py": _PALLAS,
    "ops/fused_act.py::fused_bias_act_pallas": _PALLAS,
    "ops/resample.py::smooth_upsample_unfused": _PALLAS,
    "ops/resample.py::smooth_downsample_unfused": _PALLAS,
    "utils/torch_convert.py": "JAX <-> torch weight conversion; its port "
                              "counterpart is utils/convert.py (from_jax, "
                              "to_jax)",
    **{f"train/optim.py::{name}": _OPTAX for name in (
        "add_decayed_weights_masked", "apply_grad_mask",
        "gradient_centralization", "lookahead", "ranger", "sgd_torch")},
    **{f"parallel/mesh.py::{name}": _SHARDING for name in (
        "batch_sharding", "class_sharded", "from_process_local",
        "logits_sharding", "replicated", "shard_params")},
    **{f"models/mtcnn.py::{name}": _MTCNN for name in (
        "onet_apply", "pnet_apply", "rnet_apply")},
    "models/mobilefacenet.py::ResidualStack": "a Sequential factory of the "
    "functional stack; the port's counterpart is the Residual module",
    "losses/perceptual.py::lpips_params_from_torch": "builds the JAX LPIPS "
    "tree from torch weights; the port loads them as a state_dict "
    "(tools/convert_checkpoint.py: lpips_state_dict)",
    "eval/verify_runner.py::l2_norm_np": "a numpy helper of the JAX "
    "embedder; the port normalises the embeddings on the card",
    "utils/logging.py::StepTimer": "no reader; the port's timing lives in "
                                   "utils/tracing.py",
    "tools/tune_stage3.py::scan_time": "times a lax.scan of steps on the "
    "TPU; the port times its steps with CUDA synchronisation",
    "tools/align_faces.py": "out of scope: needs dlib, which does not "
                            "import here",
    "tools/download_faceset.py": "out of scope: needs the network",
    "tools/tpu_smoke.py": "TPU only; chip_smoke.py is its counterpart",
    "tools/verify_parity.py": _REFERENCE,
    "tools/train_reference_stage2.py": _REFERENCE,
    "tools/train_reference_baseline.py": _REFERENCE,
}

# ROADMAP section A's last queue: each is ported, so none may stand here
PORTED_LAST = ("data/dataset.py::device_augment",
               "ops/modconv.py::modulated_conv2d_grouped",
               "utils/checkpoint.py::resolve_checkpoint_dir",
               "utils/config.py::Stage2Options",
               "utils/config.py::Stage2TestOptions",
               "utils/export.py::export_jittable")


def public_names(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _pairs():
    """(key prefix, JAX file, port file) for every module and root tool."""
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                out.append((rel.replace(os.sep, "/"),
                            os.path.join(JAX_PKG, rel),
                            os.path.join(PORT_PKG, rel)))
    tools = os.path.join(REPO, "tools")
    for f in sorted(os.listdir(tools)):
        if f.endswith(".py"):
            out.append((f"tools/{f}", os.path.join(tools, f),
                        os.path.join(PORT_PKG, "tools", f)))
    return sorted(out)


PAIRS = _pairs()


@pytest.mark.parametrize("rel,jax_file,port_file", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_module_has_a_port_counterpart(rel, jax_file, port_file):
    names = public_names(jax_file)
    if rel in JAX_ONLY:
        return
    if rel.startswith("tools/") or names:
        assert os.path.exists(port_file), \
            f"{rel}: no port counterpart and no JAX_ONLY reason"
    if not names:
        return
    missing = sorted(n for n in names - public_names(port_file)
                     if f"{rel}::{n}" not in JAX_ONLY)
    assert not missing, (f"{rel}: {missing} have no counterpart in the "
                         f"port and no JAX_ONLY reason")


def test_jax_only_entries_are_true_and_reasoned():
    """Each entry names something the JAX package has and the port lacks,
    with a reason; none is an item the port now has."""
    files = {rel: (j, p) for rel, j, p in PAIRS}
    for key, reason in JAX_ONLY.items():
        assert reason.strip(), key
        rel, _, name = key.partition("::")
        assert rel in files, f"{key}: no such JAX module or tool"
        jax_file, port_file = files[rel]
        if name:
            assert name in public_names(jax_file), f"{key}: not in JAX"
            assert not os.path.exists(port_file) or \
                name not in public_names(port_file), \
                f"{key}: the port has it; drop the entry"
        else:
            assert not os.path.exists(port_file), \
                f"{key}: the port has this module; drop the entry"
    for key in PORTED_LAST:
        assert key not in JAX_ONLY, key
