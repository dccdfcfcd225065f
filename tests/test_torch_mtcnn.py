"""The port's MTCNN against the JAX package's on the CPU, with the real
PNet/RNet/ONet weights that ship with both packages:

  * the weight files are the JAX package's, byte for byte, and
    ``load_mtcnn`` loads the JAX package's arrays with ``strict=True``;
  * PNet at every pyramid shape of a 250² image (min_face_size 20), RNet
    on 24² and ONet on 48² batches: within 1e-5 of the output's scale
    (f32 convolutions summed in other orders); the ceil-mode max-pool's
    output equal to the JAX ``_maxpool_ceil``'s at every pyramid shape;
  * the host box functions, exact on seeded boxes;
  * the similarity transform within 1e-6;
  * the port's tensor warp against ``cv2.warpAffine`` through the JAX
    ``warp_and_crop_face`` and ``tools/mtcnn_crop_align.ldms_transform``:
    at most one level, on at most 0.1 % of the pixels (OpenCV 5 computes
    the bilinear warp in floating point, the port in float64: a value
    within round-off of a half level rounds either way);
  * ``detect_faces`` and ``align_multi`` through the whole cascade on
    seeded drawn faces (``chip_smoke.draw_faces``) that reach ONet: the
    same number of faces, boxes and landmarks within 1e-3 pixel, aligned
    crops within one level; a disagreement is allowed only where one side
    agrees with a float64 run of the port (a score within round-off of a
    threshold).
Run with ``-s`` to see each deviation beside its tolerance.
"""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import draw_faces
from stylegan_for_facerec_tpu.models import mtcnn as jm
from stylegan_for_facerec_torch.models import mtcnn as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET_TOL = 1e-5          # of the output's largest magnitude
SIM_TOL = 1e-6
BOX_TOL = 1e-3          # pixels, boxes and landmarks through the cascade
WARP_FRAC = 1e-3        # share of pixels a level off cv2 / the JAX crop


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, set before the module's fixtures run: the test
    workers already share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jdet():
    return jm.MTCNN()


@pytest.fixture(scope="module")
def nets():
    """The port's nets loaded from the JAX package's own arrays."""
    return tm.load_mtcnn(weights={n: jm._load_weights(n)
                                  for n in ("pnet", "rnet", "onet")})


@pytest.fixture(scope="module")
def det():
    return tm.MTCNN(device="cpu")


@pytest.fixture(scope="module")
def det64():
    d = tm.MTCNN(device="cpu")
    for net in (d.pnet, d.rnet, d.onet):
        net.double()
    return d


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_weights_are_the_jax_packages():
    for name in ("pnet", "rnet", "onet"):
        mine = os.path.join(tm.WEIGHTS_DIR, f"{name}.npy")
        theirs = os.path.join(jm.WEIGHTS_DIR, f"{name}.npy")
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), name
    net = tm.load_mtcnn()[2]
    bad = dict(jm._load_weights("onet"), extra=np.zeros(1))
    with pytest.raises(RuntimeError, match="extra"):
        net.load_state_dict({k: torch.from_numpy(np.asarray(v))
                             for k, v in bad.items()}, strict=True)


PYRAMID = [(math.ceil(250 * s), math.ceil(250 * s))
           for s in tm.pyramid_scales(250, 250, 20.0)]


def test_pyramid_is_the_jax_detectors():
    """The scales ``detect_faces`` of the JAX package resizes to, read off
    the images its PNet receives."""
    seen = []

    class Spy(jm.MTCNN):
        def _run_first_stage(self, image, scale, threshold):
            seen.append(scale)
            return None

    Spy().detect_faces(Image.new("RGB", (250, 250)))
    assert seen == tm.pyramid_scales(250, 250, 20.0)
    assert len(PYRAMID) == 8


@pytest.mark.parametrize("shape", PYRAMID)
def test_pnet_at_pyramid_shape(nets, shape):
    h, w = shape
    x = np.random.RandomState(h).uniform(-1, 1, (1, h, w, 3)).astype(
        np.float32)
    jb, ja = jm.pnet_apply(jm._load_weights("pnet"), x)
    with torch.no_grad():
        tb, ta = nets[0](torch.from_numpy(x).permute(0, 3, 1, 2))
    got_b = tb.permute(0, 2, 3, 1).numpy()
    got_a = ta.permute(0, 2, 3, 1).numpy()
    assert got_b.shape == np.asarray(jb).shape
    eb, ea = _rel(got_b, jb), _rel(got_a, ja)
    print(f"PNet {h}x{w}: offsets {eb:.2e}, probs {ea:.2e} of scale "
          f"(tolerance {NET_TOL:g})")
    assert eb <= NET_TOL and ea <= NET_TOL
    # the ceil-mode pool against the JAX package's, exactly
    y = np.random.RandomState(w).randn(1, h - 2, w - 2, 10).astype(np.float32)
    want = np.asarray(jm._maxpool_ceil(y, 2, 2))
    got = tm._pool(2, 2)(torch.from_numpy(y).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("name,size", [("rnet", 24), ("onet", 48)])
def test_rnet_onet(nets, name, size):
    x = np.random.RandomState(size).uniform(-1, 1, (16, size, size, 3)) \
        .astype(np.float32)
    want = (jm.rnet_apply if name == "rnet" else jm.onet_apply)(
        jm._load_weights(name), x)
    net = nets[1] if name == "rnet" else nets[2]
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, wnt in zip(got, want):
        e = _rel(g.numpy(), wnt)
        print(f"{name} output {tuple(g.shape)}: {e:.2e} of scale "
              f"(tolerance {NET_TOL:g})")
        assert g.shape == np.asarray(wnt).shape and e <= NET_TOL
    for k in (3, 2):       # the pools of RNet and ONet at their sizes
        for hw in (22, 21, 10, 9, 4, 3):
            y = np.random.RandomState(hw).randn(2, hw, hw, 4).astype(
                np.float32)
            np.testing.assert_array_equal(
                tm._pool(k, 2)(torch.from_numpy(y).permute(0, 3, 1, 2))
                .permute(0, 2, 3, 1).numpy(),
                np.asarray(jm._maxpool_ceil(y, k, 2)))


def _boxes(seed, n=60):
    rng = np.random.RandomState(seed)
    b = rng.uniform(-20, 120, (n, 9)).astype(np.float32)
    b[:, 2:4] = b[:, 0:2] + rng.uniform(3, 60, (n, 2))
    b[:, 4] = rng.rand(n)
    b[:3, 4] = 0.5          # score ties
    return b


@pytest.mark.parametrize("fn", ["nms", "convert_to_square", "calibrate_box",
                                "correct_bboxes", "get_image_boxes",
                                "preprocess", "generate_bboxes"])
def test_box_math_exact(fn):
    b = _boxes(3)
    rng = np.random.RandomState(4)
    if fn == "nms":
        for mode in ("union", "min"):
            for thr in (0.3, 0.5, 0.7):
                assert tm.nms(b[:, :5], thr, mode) == \
                    jm.nms(b[:, :5], thr, mode)
        assert tm.nms(b[:0]) == jm.nms(b[:0]) == []
        return
    if fn == "convert_to_square":
        got, want = tm.convert_to_square(b), jm.convert_to_square(b)
    elif fn == "calibrate_box":
        off = rng.randn(len(b), 4).astype(np.float32) * 0.2
        got, want = tm.calibrate_box(b[:, :5], off), \
            jm.calibrate_box(b[:, :5], off)
    elif fn == "correct_bboxes":
        sq = np.round(jm.convert_to_square(b))
        for g, wnt in zip(tm.correct_bboxes(sq, 100, 90),
                          jm.correct_bboxes(sq, 100, 90)):
            assert g.dtype == wnt.dtype
            np.testing.assert_array_equal(g, wnt)
        return
    elif fn == "get_image_boxes":
        img = Image.fromarray(rng.randint(0, 256, (90, 100, 3), np.uint8))
        sq = np.round(jm.convert_to_square(b))
        # boxes that overlap the image, some past its edges
        sq = sq[(sq[:, 0] < 99) & (sq[:, 1] < 89) & (sq[:, 2] > 0)
                & (sq[:, 3] > 0)]
        assert len(sq) > 20 and (sq[:, :2] < 0).any() and (sq[:, 2] > 99).any()
        got, want = tm.get_image_boxes(sq, img, 24), \
            jm.get_image_boxes(sq, img, 24)
    elif fn == "preprocess":
        img = rng.randint(0, 256, (30, 40, 3)).astype(np.float32)
        got, want = tm.preprocess(img), jm.preprocess(img)
    else:
        probs = rng.rand(20, 25).astype(np.float32)
        offs = rng.randn(20, 25, 4).astype(np.float32)
        got = tm.generate_bboxes(probs, offs, 0.37, 0.6)
        want = jm.MTCNN._generate_bboxes(probs, offs, 0.37, 0.6)
        assert len(tm.generate_bboxes(probs, offs, 0.37, 1.0)) == 0
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_similarity_transform():
    for kw in ({}, {"default_square": True},
               {"output_size": (112, 112), "default_square": True},
               {"output_size": (128, 144), "inner_padding_factor": 0.1,
                "outer_padding": (4, 6)}):
        e = _rel(tm.get_reference_facial_points(**kw),
                 jm.get_reference_facial_points(**kw))
        assert e <= SIM_TOL, kw
    rng = np.random.RandomState(5)
    dst = jm.get_reference_facial_points(default_square=True)
    worst = 0.0
    for _ in range(20):
        src = rng.uniform(0, 200, (5, 2))
        for reflective in (True, False):
            worst = max(worst, _rel(
                tm.get_similarity_transform_for_cv2(src, dst, reflective),
                jm.get_similarity_transform_for_cv2(src, dst, reflective)))
        for g, wnt in zip(tm.find_nonreflective_similarity(src, dst),
                          jm.find_nonreflective_similarity(src, dst)):
            worst = max(worst, _rel(g, wnt))
    # a mirrored point set takes the reflective branch
    src = dst.astype(np.float64).copy()
    src[:, 0] = 150 - src[:, 0]
    m = tm.get_similarity_transform_for_cv2(src, dst)
    worst = max(worst, _rel(m, jm.get_similarity_transform_for_cv2(src,
                                                                   dst)))
    assert np.linalg.det(m[:, :2]) < 0
    print(f"similarity transforms: {worst:.2e} of scale (tolerance "
          f"{SIM_TOL:g})")
    assert worst <= SIM_TOL


def _levels(got, want):
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    return int(d.max()), float((d > 0).mean())


def test_warp_against_cv2():
    jtool = _jax_tool("mtcnn_crop_align")
    from stylegan_for_facerec_torch.tools import mtcnn_crop_align as ptool
    rng = np.random.RandomState(6)
    ref = jm.get_reference_facial_points(default_square=True)
    worst, fracs = 0, []
    for i in range(8):
        h, w = rng.randint(90, 260, 2)
        img = draw_faces(i, w, h, 1, 30, 60) if i % 2 else Image.fromarray(
            rng.randint(0, 256, (h, w, 3), np.uint8))
        arr = np.asarray(img)
        pts = ref * rng.uniform(0.6, 1.8) + rng.uniform(-10, 40, 2) \
            + rng.randn(5, 2) * 3
        got, gm = tm.warp_and_crop_face(arr, pts, ref, device="cpu")
        want, wm = jm.warp_and_crop_face(arr, pts, ref)
        np.testing.assert_array_equal(gm, wm)
        for a, b in ((got, want), (ptool.ldms_transform(arr, pts, 112, "cpu"),
                                   jtool.ldms_transform(arr, pts, 112)),
                     (ptool.ldms_transform(arr, pts, 128, "cpu"),
                      jtool.ldms_transform(arr, pts, 128))):
            assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
            m, f = _levels(a, b)
            worst, fracs = max(worst, m), fracs + [f]
    # float images keep their dtype and are not rounded
    fimg = torch.rand(40, 50, 3, dtype=torch.float64)
    out = tm.warp_affine(fimg, np.array([[1, 0, -0.5], [0, 1, 0]]), (50, 40))
    assert out.dtype == torch.float64
    torch.testing.assert_close(out[:, :-1], 0.5 * (fimg[:, :-1] + fimg[:, 1:]))
    print(f"warp vs cv2: max {worst} level(s), {max(fracs):.2e} of pixels "
          f"off at worst (tolerance 1 level on {WARP_FRAC:g})")
    assert worst <= 1 and max(fracs) <= WARP_FRAC


def _agree(a, b) -> bool:
    (ba, la), (bb, lb) = a, b
    if len(ba) != len(bb):
        return False
    return len(ba) == 0 or (
        np.abs(np.asarray(ba) - np.asarray(bb)).max() <= BOX_TOL
        and np.abs(np.asarray(la) - np.asarray(lb)).max() <= BOX_TOL)


CASCADE = [  # (seed, w, h, faces, sizes, detect_faces keywords)
    (0, 250, 250, 1, (50, 90), {}),
    (1, 250, 200, 2, (30, 50), {}),
    (2, 300, 260, 3, (20, 45), {}),
    (3, 250, 250, 0, (0, 1), {}),
    (4, 512, 384, 1, (80, 150),
     {"min_face_size": 100.0, "thresholds": (0.9, 0.9, 0.9),
      "nms_thresholds": (0.9, 0.9, 0.9)}),
]


@pytest.mark.parametrize("case", CASCADE, ids=lambda c: f"seed{c[0]}")
def test_detect_faces(jdet, det, det64, case):
    seed, w, h, n, (smin, smax), kw = case
    img = draw_faces(seed, w, h, n, smin, smax) if n else Image.fromarray(
        np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8))
    want = jdet.detect_faces(img, **kw)
    got = det.detect_faces(img, **kw)
    if n:
        assert len(got[0]) > 0, "no face reached ONet's output"
    if len(got[0]):
        eb = float(np.abs(np.asarray(got[0]) - want[0]).max()) \
            if len(got[0]) == len(want[0]) else float("inf")
        el = float(np.abs(np.asarray(got[1]) - want[1]).max()) \
            if len(got[1]) == len(want[1]) else float("inf")
        print(f"detect_faces seed {seed}: {len(got[0])} faces (JAX "
              f"{len(want[0])}), boxes {eb:.2e} px, landmarks {el:.2e} px "
              f"(tolerance {BOX_TOL:g})")
    if not _agree(got, want):
        exact = det64.detect_faces(img, **kw)
        assert _agree(got, exact) or _agree(want, exact), \
            "port and JAX differ and neither agrees with float64"


def test_align_multi_and_show(jdet, det):
    img = draw_faces(1, 250, 200, 2, 30, 50)
    jb, jfaces, jt = jdet.align_multi(img, limit=2, min_face_size=20.0)
    b, faces, t = det.align_multi(img, limit=2, min_face_size=20.0)
    assert len(faces) == len(jfaces) == 2
    worst = 0
    for f, jf, m, jmat in zip(faces, jfaces, t, jt):
        assert f.size == jf.size == (112, 112)
        np.testing.assert_allclose(m, jmat, atol=1e-4)
        lv, frac = _levels(np.asarray(f), np.asarray(jf))
        worst = max(worst, lv)
        assert frac <= 0.01
    print(f"align_multi crops: max {worst} level(s) off the JAX crops "
          f"(tolerance 1)")
    assert worst <= 1
    face, _ = det.align(img)
    jface, _ = jdet.align(img)
    assert face.size == (112, 112)
    assert _levels(np.asarray(face), np.asarray(jface))[0] <= 1
    np.testing.assert_array_equal(
        np.asarray(det.show_bboxes(img, b, det.detect_faces(img)[1])),
        np.asarray(jdet.show_bboxes(img, jb, jdet.detect_faces(img)[1])))


def test_detector_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.MTCNN()
