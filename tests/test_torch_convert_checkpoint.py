"""The port's ``tools/convert_checkpoint.py`` against the JAX package's
converters, on the CPU, for every model kind and LPIPS.

* ``to_torch``: a JAX checkpoint directory (written by the JAX package's
  ``save_checkpoint`` from JAX ``from_torch`` trees) becomes the state_dict
  that JAX ``utils/torch_convert.py::to_torch`` emits, key for key and
  bit for bit.
* ``to_jax``: a reference-layout ``.pt`` becomes a checkpoint directory
  that the JAX package's ``load_checkpoint`` reads (with ``like=``) as
  exactly the trees of JAX ``from_torch``, and whose manifest describes
  the same tree as JAX's.

Weights are the port's, drawn from a seed; the models are at their CLI
sizes (IR-50/IR-SE-50/PSpFaceRec at 112), pSp and the ADA generator at
32 px.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from stylegan_for_facerec_tpu.models import irse as jirse
from stylegan_for_facerec_tpu.models import psp as jpsp
from stylegan_for_facerec_tpu.models import stylegan2_ada as jada
from stylegan_for_facerec_tpu.utils import checkpoint as jckpt
from stylegan_for_facerec_tpu.utils import torch_convert as tc
from stylegan_for_facerec_torch.nn.initializers import init_weights
from stylegan_for_facerec_torch.tools import convert_checkpoint as cc
from stylegan_for_facerec_torch.utils.checkpoint import read_jax_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
# kind: (JAX model, JAX flatten_info)
KINDS = {
    "ir50": (lambda: jirse.IR_50(112), {"output_layer.3": (7, 7, 512)}),
    "ir_se50": (lambda: jirse.IR_SE_50(112), {"output_layer.3": (7, 7, 512)}),
    "psp_facerec": (lambda: jpsp.PSpFaceRec(size=112),
                    {"encoder.output_layer.3": (7, 7, 512)}),
    "psp": (lambda: jpsp.PSp(output_size=SIZE), {}),
    "ada_generator": (lambda: jada.Generator(img_resolution=SIZE), {}),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_state_dict(kind):
    """A seeded port model's state_dict under the reference names (the
    out-of-band ``avg_image`` of ``PSpFaceRec`` is not among them)."""
    model = cc.build_model(kind, SIZE)
    init_weights(model, torch.Generator().manual_seed(len(kind)))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(generator=torch.Generator()
                                       .manual_seed(m.num_features))
    sd = model.state_dict()
    sd.pop("avg_image", None)
    return sd


def assert_trees_equal(got, want, path=""):
    assert set(got) == set(want), (path, sorted(set(got) ^ set(want))[:5])
    for k, w in want.items():
        if isinstance(w, dict):
            assert_trees_equal(got[k], w, f"{path}.{k}")
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(w),
                                          err_msg=f"{path}.{k}")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_to_torch_matches_jax(kind, tmp_path):
    jm, flat = KINDS[kind][0](), KINDS[kind][1]
    sd = {k: v.numpy() for k, v in reference_state_dict(kind).items()}
    params, state = tc.from_torch(jm, sd, flatten_info=flat)
    jckpt.save_checkpoint(str(tmp_path / "jax"), {"params": params,
                                                  "state": state})
    cc.main(["to_torch", "--model", kind, "--src", str(tmp_path / "jax"),
             "--dst", str(tmp_path / "out.pt"), "--output_size", str(SIZE)])
    got = torch.load(tmp_path / "out.pt", weights_only=True)
    want = tc.to_torch(jm, params, state, flatten_info=flat)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_to_jax_loads_as_jax_from_torch(kind, tmp_path):
    jm, flat = KINDS[kind][0](), KINDS[kind][1]
    sd = reference_state_dict(kind)
    torch.save({"state_dict": {f"encoder.{k}": v for k, v in sd.items()}},
               tmp_path / "ref.pt")
    cc.main(["to_jax", "--model", kind, "--src", str(tmp_path / "ref.pt"),
             "--dst", str(tmp_path / "jax"), "--output_size", str(SIZE),
             "--key_prefix", "encoder", "--strict"])
    params, state = tc.from_torch(jm, {k: v.numpy() for k, v in sd.items()},
                                  flatten_info=flat)
    want = {"params": params, "state": state}
    got = jckpt.load_checkpoint(str(tmp_path / "jax"), like=want)
    assert_trees_equal(got, want)
    assert read_jax_checkpoint(str(tmp_path / "jax")).keys() == want.keys()
    with open(tmp_path / "jax" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["treedef"] == str(jax.tree_util.tree_structure(want))
    assert manifest["metadata"]["model"] == kind


def test_lpips_to_jax_matches_jax(tmp_path):
    from stylegan_for_facerec_tpu.losses.perceptual import LPIPS as JLPIPS

    model = cc.build_model("lpips")
    init_weights(model, torch.Generator().manual_seed(5))
    model.init_weights_(torch.Generator().manual_seed(6))
    sd = model.state_dict()
    torch.save({f"features.{k[4:]}": v for k, v in sd.items()
                if k.startswith("net.")}, tmp_path / "alex.pth")
    torch.save({f"lin{i}.model.1.weight": sd[f"lin.{i}.weight"]
                for i in range(5)}, tmp_path / "lin.pth")
    spec = importlib.util.spec_from_file_location(
        "jax_convert_checkpoint", os.path.join(REPO, "tools",
                                               "convert_checkpoint.py"))
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    jcli.convert_lpips(str(tmp_path / "lin.pth"),
                       str(tmp_path / "alex.pth"), str(tmp_path / "want"))
    cc.main(["to_jax", "--model", "lpips", "--src",
             str(tmp_path / "lin.pth"), "--alexnet",
             str(tmp_path / "alex.pth"), "--dst", str(tmp_path / "got")])
    want = jckpt.load_checkpoint(str(tmp_path / "want"))
    got = jckpt.load_checkpoint(str(tmp_path / "got"), like=want)
    assert_trees_equal(got, want)
    # the tree a JAX LPIPS holds
    params, _ = JLPIPS().init(jax.random.key(0))
    assert jax.tree_util.tree_structure(params) == \
        jax.tree_util.tree_structure(want)
