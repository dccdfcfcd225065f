"""MTCNN face detector and 5-point aligner, as
``stylegan_for_facerec_tpu/models/mtcnn.py`` (the mtcnn-pytorch lineage).

PNet, RNet and ONet are ``nn.Module``s in NCHW, the layout of their
weights, which ship with this package (``data/mtcnn_weights``, the public
mtcnn-pytorch ``.npy`` dicts under their torch names) and load with
``strict=True``. Two quirks of that fork are kept: PNet's softmax runs over
the width axis, and the caffe ``Flatten`` orders (C, W, H). The nets run on
the detector's device; the image pyramid, NMS, box calibration and
cropping are numpy and PIL on the host, as in the JAX package. Alignment
solves the Matlab ``cp2tform`` similarity and warps with ``warp_affine``,
a bilinear warp on tensors that does what ``cv2.warpAffine`` does with its
default flags.
"""

from __future__ import annotations

import math
import os
from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device

WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                           "data", "mtcnn_weights")


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------

class Flatten(nn.Module):
    """The caffe flatten of the fork: (N, C, H, W) -> (N, C * W * H) in
    (C, W, H) order."""

    def forward(self, x):
        return x.transpose(3, 2).contiguous().view(x.shape[0], -1)


def _pool(k: int, s: int) -> nn.MaxPool2d:
    return nn.MaxPool2d(k, s, ceil_mode=True)


class PNet(nn.Module):
    """Proposal net: (offsets (N, 4, h, w), probs (N, 2, h, w)) with the
    softmax over the width axis, as the fork computes it (its stage-1
    threshold of 0.15 was tuned against that)."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 10, 3)), ("prelu1", nn.PReLU(10)),
            ("pool1", _pool(2, 2)),
            ("conv2", nn.Conv2d(10, 16, 3)), ("prelu2", nn.PReLU(16)),
            ("conv3", nn.Conv2d(16, 32, 3)), ("prelu3", nn.PReLU(32))]))
        self.conv4_1 = nn.Conv2d(32, 2, 1)
        self.conv4_2 = nn.Conv2d(32, 4, 1)

    def forward(self, x):
        x = self.features(x)
        return self.conv4_2(x), torch.softmax(self.conv4_1(x), dim=-1)


class RNet(nn.Module):
    """Refinement net on 24² crops: (offsets (N, 4), probs (N, 2))."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 28, 3)), ("prelu1", nn.PReLU(28)),
            ("pool1", _pool(3, 2)),
            ("conv2", nn.Conv2d(28, 48, 3)), ("prelu2", nn.PReLU(48)),
            ("pool2", _pool(3, 2)),
            ("conv3", nn.Conv2d(48, 64, 2)), ("prelu3", nn.PReLU(64)),
            ("flatten", Flatten()),
            ("conv4", nn.Linear(576, 128)), ("prelu4", nn.PReLU(128))]))
        self.conv5_1 = nn.Linear(128, 2)
        self.conv5_2 = nn.Linear(128, 4)

    def forward(self, x):
        x = self.features(x)
        return self.conv5_2(x), torch.softmax(self.conv5_1(x), dim=-1)


class ONet(nn.Module):
    """Output net on 48² crops: (landmarks (N, 10), offsets (N, 4), probs
    (N, 2))."""

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(OrderedDict([
            ("conv1", nn.Conv2d(3, 32, 3)), ("prelu1", nn.PReLU(32)),
            ("pool1", _pool(3, 2)),
            ("conv2", nn.Conv2d(32, 64, 3)), ("prelu2", nn.PReLU(64)),
            ("pool2", _pool(3, 2)),
            ("conv3", nn.Conv2d(64, 64, 3)), ("prelu3", nn.PReLU(64)),
            ("pool3", _pool(2, 2)),
            ("conv4", nn.Conv2d(64, 128, 2)), ("prelu4", nn.PReLU(128)),
            ("flatten", Flatten()),
            ("conv5", nn.Linear(1152, 256)), ("prelu5", nn.PReLU(256))]))
        self.conv6_1 = nn.Linear(256, 2)
        self.conv6_2 = nn.Linear(256, 4)
        self.conv6_3 = nn.Linear(256, 10)

    def forward(self, x):
        x = self.features(x)
        return (self.conv6_3(x), self.conv6_2(x),
                torch.softmax(self.conv6_1(x), dim=-1))


def load_weights(name: str, weights_dir: Optional[str] = None) -> dict:
    """The ``{torch name: array}`` dict of ``<weights_dir>/<name>.npy``."""
    path = os.path.join(weights_dir or WEIGHTS_DIR, f"{name}.npy")
    return np.load(path, allow_pickle=True)[()]


def load_mtcnn(weights_dir: Optional[str] = None, weights=None):
    """(PNet, RNet, ONet) in eval mode on the CPU, each loaded with
    ``strict=True`` from ``weights`` ({"pnet": dict, ...}) or from the
    ``.npy`` files of ``weights_dir`` (default: the package's)."""
    nets = []
    for name, cls in (("pnet", PNet), ("rnet", RNet), ("onet", ONet)):
        d = weights[name] if weights is not None \
            else load_weights(name, weights_dir)
        net = cls()
        net.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                             for k, v in d.items()}, strict=True)
        nets.append(net.eval().requires_grad_(False))
    return tuple(nets)


# ---------------------------------------------------------------------------
# Host box math (numpy)
# ---------------------------------------------------------------------------

def _pairwise_overlap(boxes: np.ndarray, mode: str) -> np.ndarray:
    """All-pairs overlap of (x1, y1, x2, y2, ...) rows with +1-inclusive
    pixel areas: IoU for 'union', intersection over the smaller area for
    'min'."""
    x1, y1, x2, y2 = (boxes[:, i] for i in range(4))
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = np.minimum(x2[:, None], x2[None, :]) \
        - np.maximum(x1[:, None], x1[None, :]) + 1.0
    ih = np.minimum(y2[:, None], y2[None, :]) \
        - np.maximum(y1[:, None], y1[None, :]) + 1.0
    inter = np.maximum(iw, 0.0) * np.maximum(ih, 0.0)
    if mode == "min":
        return inter / np.minimum(area[:, None], area[None, :])
    return inter / (area[:, None] + area[None, :] - inter)


def nms(boxes: np.ndarray, overlap_threshold: float = 0.5,
        mode: str = "union") -> List[int]:
    """Greedy non-maximum suppression in descending score order (column
    4): a pick suppresses every box whose overlap exceeds the threshold."""
    n = len(boxes)
    if n == 0:
        return []
    overlap = _pairwise_overlap(boxes, mode)
    order = np.argsort(boxes[:, 4])[::-1]
    alive = np.ones(n, dtype=bool)
    pick: List[int] = []
    for i in order:
        if not alive[i]:
            continue
        pick.append(int(i))
        alive &= overlap[i] <= overlap_threshold
    return pick


def convert_to_square(bboxes: np.ndarray) -> np.ndarray:
    """Each box grown to the square about its centre; the other columns
    come back zero (every caller sets them again)."""
    x1, y1, x2, y2 = (bboxes[:, i] for i in range(4))
    w = x2 - x1 + 1.0
    h = y2 - y1 + 1.0
    side = np.maximum(h, w)
    sx1 = x1 + w * 0.5 - side * 0.5
    sy1 = y1 + h * 0.5 - side * 0.5
    square = np.zeros_like(bboxes)
    square[:, :4] = np.stack(
        [sx1, sy1, sx1 + side - 1.0, sy1 + side - 1.0], axis=1)
    return square


def calibrate_box(bboxes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """The regression offsets applied, scaled by each box's width and
    height."""
    sizes = bboxes[:, 2:4] - bboxes[:, 0:2] + 1.0
    out = bboxes.copy()
    out[:, :4] += np.tile(sizes, 2) * offsets
    return out


def correct_bboxes(bboxes, width, height):
    """Boxes clipped to the image, as int32 [dy, edy, dx, edx, y, ey, x,
    ex, w, h]: (x..ex, y..ey) is the clipped source window, (dx..edx,
    dy..edy) its place inside the w x h padded crop."""
    x1, y1, x2, y2 = (bboxes[:, i] for i in range(4))
    w = x2 - x1 + 1.0
    h = y2 - y1 + 1.0
    x = np.maximum(x1, 0.0)
    y = np.maximum(y1, 0.0)
    ex = np.minimum(x2, width - 1.0)
    ey = np.minimum(y2, height - 1.0)
    dx = x - x1
    dy = y - y1
    edx = (w - 1.0) + (ex - x2)
    edy = (h - 1.0) + (ey - y2)
    return [v.astype("int32") for v in
            [dy, edy, dx, edx, y, ey, x, ex, w, h]]


def preprocess(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) pixels -> (1, H, W, 3) float32 (x - 127.5) / 128."""
    return ((np.asarray(img, np.float32) - 127.5) * 0.0078125)[None]


def get_image_boxes(bounding_boxes, img, size=24) -> np.ndarray:
    """Each box cropped from the PIL image ``img`` (zero-padded where it
    leaves the image), resized to ``size``² and preprocessed: (N, size,
    size, 3) float32."""
    from PIL import Image
    num = len(bounding_boxes)
    width, height = img.size
    dy, edy, dx, edx, y, ey, x, ex, w, h = correct_bboxes(
        bounding_boxes, width, height)
    out = np.zeros((num, size, size, 3), "float32")
    img_array = np.asarray(img, "uint8")
    for i in range(num):
        if h[i] <= 0 or w[i] <= 0:
            continue
        box = np.zeros((h[i], w[i], 3), "uint8")
        box[dy[i]:edy[i] + 1, dx[i]:edx[i] + 1] = \
            img_array[y[i]:ey[i] + 1, x[i]:ex[i] + 1]
        box = Image.fromarray(box).resize((size, size), Image.BILINEAR)
        out[i] = (np.asarray(box, "float32") - 127.5) * 0.0078125
    return out


def generate_bboxes(probs, offsets, scale, threshold) -> np.ndarray:
    """PNet's (h, w) face probabilities and (h, w, 4) offsets at pyramid
    ``scale`` -> (n, 9) candidate rows [x1, y1, x2, y2, score, offsets]
    in image pixels (12-pixel cells, stride 2)."""
    stride, cell = 2, 12
    inds = np.where(probs > threshold)
    if inds[0].size == 0:
        return np.array([])
    offs = offsets[inds[0], inds[1]].T
    score = probs[inds[0], inds[1]]
    boxes = np.vstack([
        np.round((stride * inds[1] + 1.0) / scale),
        np.round((stride * inds[0] + 1.0) / scale),
        np.round((stride * inds[1] + 1.0 + cell) / scale),
        np.round((stride * inds[0] + 1.0 + cell) / scale),
        score, offs])
    return boxes.T


def pyramid_scales(width: int, height: int,
                   min_face_size: float = 20.0) -> List[float]:
    """The image pyramid's scales: from 12 / min_face_size down by 0.707
    while the short side stays above 12 pixels."""
    min_detection_size, factor = 12, 0.707
    m = min_detection_size / min_face_size
    min_length = min(height, width) * m
    scales, count = [], 0
    while min_length > min_detection_size:
        scales.append(m * factor ** count)
        min_length *= factor
        count += 1
    return scales


# ---------------------------------------------------------------------------
# Alignment (align_trans / matlab_cp2tform)
# ---------------------------------------------------------------------------

REFERENCE_FACIAL_POINTS = np.array([
    [30.29459953, 51.69630051], [65.53179932, 51.50139999],
    [48.02519989, 71.73660278], [33.54930115, 92.3655014],
    [62.72990036, 92.20410156]], np.float32)
DEFAULT_CROP_SIZE = (96, 112)


def get_reference_facial_points(output_size=None, inner_padding_factor=0.0,
                                outer_padding=(0, 0),
                                default_square=False) -> np.ndarray:
    """The five reference points for a crop of ``output_size`` (w, h)."""
    pts = REFERENCE_FACIAL_POINTS.copy()
    crop = np.array(DEFAULT_CROP_SIZE, np.float32)
    if default_square:
        diff = crop.max() - crop
        pts += diff / 2
        crop += diff
    if output_size is None or tuple(np.asarray(output_size)) == \
            tuple(crop.astype(int)):
        if inner_padding_factor == 0 and tuple(outer_padding) == (0, 0):
            return pts
    if output_size is None:
        size_diff = crop * inner_padding_factor * 2
        output_size = tuple((crop + size_diff
                             + np.asarray(outer_padding) * 2).astype(int))
    size_bf_outer = np.asarray(output_size) - np.asarray(outer_padding) * 2
    scale = size_bf_outer[0] / (crop[0] * (1 + inner_padding_factor * 2))
    pts = (pts + crop * inner_padding_factor) * scale
    pts = pts + np.asarray(outer_padding)
    return pts.astype(np.float32)


def find_nonreflective_similarity(uv: np.ndarray, xy: np.ndarray):
    """Least-squares similarity [sc, ss, tx, ty] taking ``xy`` to ``uv``:
    (T, T^-1) as 3 x 3 row-vector matrices."""
    M = xy.shape[0]
    x = xy[:, 0:1]
    y = xy[:, 1:2]
    X = np.vstack([np.hstack([x, y, np.ones((M, 1)), np.zeros((M, 1))]),
                   np.hstack([y, -x, np.zeros((M, 1)), np.ones((M, 1))])])
    U = np.vstack([uv[:, 0:1], uv[:, 1:2]])
    r, _, _, _ = np.linalg.lstsq(X, U, rcond=None)
    sc, ss, tx, ty = np.squeeze(r)
    Tinv = np.array([[sc, -ss, 0], [ss, sc, 0], [tx, ty, 1]])
    T = np.linalg.inv(Tinv)
    T[:, 2] = [0, 0, 1]
    return T, Tinv


def get_similarity_transform_for_cv2(src_pts, dst_pts,
                                     reflective=True) -> np.ndarray:
    """The better of the direct and the Y-reflected similarity from
    ``src_pts`` to ``dst_pts``, as a 2 x 3 float32 matrix (cv2's layout)."""
    uv, xy = np.asarray(src_pts, np.float64), np.asarray(dst_pts,
                                                         np.float64)
    trans1, _ = find_nonreflective_similarity(uv, xy)
    if reflective:
        xyR = xy.copy()
        xyR[:, 0] *= -1
        trans2r, _ = find_nonreflective_similarity(uv, xyR)
        trans2 = trans2r @ np.diag([-1.0, 1.0, 1.0])
        uv1 = np.hstack([uv, np.ones((uv.shape[0], 1))])
        norm1 = np.linalg.norm((uv1 @ trans1)[:, :2] - xy)
        norm2 = np.linalg.norm((uv1 @ trans2)[:, :2] - xy)
        trans = trans1 if norm1 <= norm2 else trans2
    else:
        trans = trans1
    return trans[:, 0:2].T.astype(np.float32)


def warp_affine(img: torch.Tensor, M, size) -> torch.Tensor:
    """``cv2.warpAffine(img, M, size)`` with its default flags on a tensor
    (H, W, C) on any device: output pixel (x, y) of the (w, h) = ``size``
    image samples ``img`` bilinearly at M^-1 (x, y) (integer coordinates
    are pixel centres), taps outside the image reading 0; a uint8 result
    is rounded half up. Computed in float64. OpenCV 5 computes the same
    in floating point (a pixel within round-off of a half level may round
    the other way); OpenCV 4 rounds the coordinates to 1/32 pixel, which
    moves pixels by a few levels where the image changes fast
    (``scripts/warp_vs_cv2.py`` measures both against the installed
    OpenCV)."""
    w_out, h_out = int(size[0]), int(size[1])
    m = np.asarray(M, np.float64).reshape(2, 3)
    det = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    det = 1.0 / det if det != 0 else 0.0
    a = np.array([[m[1, 1] * det, -m[0, 1] * det, 0.0],
                  [-m[1, 0] * det, m[0, 0] * det, 0.0]])
    a[:, 2] = -a[:, :2] @ m[:, 2]
    dev = img.device
    ys = torch.arange(h_out, device=dev, dtype=torch.float64)[:, None]
    xs = torch.arange(w_out, device=dev, dtype=torch.float64)[None, :]
    sx = a[0, 0] * xs + a[0, 1] * ys + a[0, 2]
    sy = a[1, 0] * xs + a[1, 1] * ys + a[1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    h_in, w_in = img.shape[:2]
    src = img.to(torch.float64)
    out = torch.zeros((h_out, w_out) + tuple(img.shape[2:]),
                      dtype=torch.float64, device=dev)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xi, yi = (x0 + dx).long(), (y0 + dy).long()
            inside = (xi >= 0) & (xi < w_in) & (yi >= 0) & (yi < h_in)
            tap = src[yi.clamp(0, h_in - 1), xi.clamp(0, w_in - 1)]
            wgt = torch.where(inside, wy * wx, torch.zeros_like(wx))
            out += tap * wgt.reshape(wgt.shape + (1,) * (img.dim() - 2))
    if img.dtype == torch.uint8:
        return torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)
    return out.to(img.dtype)


def warp_and_crop_face(src_img, facial_pts, reference_pts=None,
                       crop_size=(112, 112), device="cuda"):
    """The face of ``src_img`` (H, W, 3) uint8 warped so that its five
    ``facial_pts`` land on ``reference_pts``: (crop (h, w, 3) uint8
    numpy, the 2 x 3 matrix); the warp runs on ``device``, the card
    unless the caller asks for the CPU."""
    if reference_pts is None:
        if crop_size == (96, 112):
            reference_pts = REFERENCE_FACIAL_POINTS
        else:
            reference_pts = get_reference_facial_points(
                crop_size, 0, (0, 0), False)
    src_pts = np.float32(facial_pts)
    ref_pts = np.float32(reference_pts)
    if src_pts.shape[0] == 2:
        src_pts = src_pts.T
    if ref_pts.shape[0] == 2:
        ref_pts = ref_pts.T
    tfm = get_similarity_transform_for_cv2(src_pts, ref_pts)
    img = torch.tensor(np.asarray(src_img), device=resolve_device(device))
    face = warp_affine(img, tfm, crop_size).cpu().numpy()
    return face, tfm


# ---------------------------------------------------------------------------
# Detector
# ---------------------------------------------------------------------------

class MTCNN:
    """The three-stage cascade: the nets on ``device`` (the card unless
    the caller asks for the CPU), the pyramid, NMS and crops on the
    host."""

    def __init__(self, weights_dir: Optional[str] = None,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        self.pnet, self.rnet, self.onet = (
            n.to(self.device) for n in load_mtcnn(weights_dir))
        self.reference = get_reference_facial_points(default_square=True)

    def _net(self, net, x: np.ndarray):
        """``net`` on (N, H, W, 3) float32 host input -> numpy outputs."""
        dtype = next(net.parameters()).dtype
        t = torch.from_numpy(x).to(self.device, dtype).permute(0, 3, 1, 2)
        with torch.no_grad():
            return [o.cpu().numpy() for o in net(t)]

    def _run_first_stage(self, image, scale, threshold):
        """PNet at one pyramid scale: candidate rows after NMS at 0.5, or
        None."""
        from PIL import Image
        width, height = image.size
        sw, sh = math.ceil(width * scale), math.ceil(height * scale)
        img = image.resize((sw, sh), Image.BILINEAR)
        offsets, probs = self._net(self.pnet,
                                   preprocess(np.asarray(img, "float32")))
        boxes = generate_bboxes(probs[0, 1], offsets[0].transpose(1, 2, 0),
                                scale, threshold)
        if len(boxes) == 0:
            return None
        keep = nms(boxes[:, 0:5], overlap_threshold=0.5)
        return boxes[keep]

    def detect_faces(self, image, min_face_size=20.0,
                     thresholds=(0.15, 0.25, 0.35),
                     nms_thresholds=(0.7, 0.7, 0.7)):
        """(boxes (n, 5) [x1, y1, x2, y2, score], landmarks (n, 10) [x1..x5,
        y1..y5]) of the faces in the PIL image; ([], []) when none."""
        width, height = image.size
        bounding_boxes = [
            self._run_first_stage(image, s, thresholds[0])
            for s in pyramid_scales(width, height, min_face_size)]
        bounding_boxes = [b for b in bounding_boxes if b is not None]
        if not bounding_boxes:
            return [], []
        bounding_boxes = np.vstack(bounding_boxes)
        keep = nms(bounding_boxes[:, 0:5], nms_thresholds[0])
        bounding_boxes = bounding_boxes[keep]
        bounding_boxes = calibrate_box(bounding_boxes[:, 0:5],
                                       bounding_boxes[:, 5:])
        bounding_boxes = convert_to_square(bounding_boxes)
        bounding_boxes[:, 0:4] = np.round(bounding_boxes[:, 0:4])

        # stage 2
        img_boxes = get_image_boxes(bounding_boxes, image, size=24)
        if len(img_boxes) == 0:
            return [], []
        offsets, probs = self._net(self.rnet, img_boxes)
        keep = np.where(probs[:, 1] > thresholds[1])[0]
        bounding_boxes = bounding_boxes[keep]
        bounding_boxes[:, 4] = probs[keep, 1]
        offsets = offsets[keep]
        keep = nms(bounding_boxes, nms_thresholds[1])
        bounding_boxes = calibrate_box(bounding_boxes[keep], offsets[keep])
        bounding_boxes = convert_to_square(bounding_boxes)
        bounding_boxes[:, 0:4] = np.round(bounding_boxes[:, 0:4])

        # stage 3
        img_boxes = get_image_boxes(bounding_boxes, image, size=48)
        if len(img_boxes) == 0:
            return [], []
        landmarks, offsets, probs = self._net(self.onet, img_boxes)
        keep = np.where(probs[:, 1] > thresholds[2])[0]
        bounding_boxes = bounding_boxes[keep]
        bounding_boxes[:, 4] = probs[keep, 1]
        offsets = offsets[keep]
        landmarks = landmarks[keep]
        w = bounding_boxes[:, 2] - bounding_boxes[:, 0] + 1.0
        h = bounding_boxes[:, 3] - bounding_boxes[:, 1] + 1.0
        landmarks[:, 0:5] = bounding_boxes[:, 0:1] + w[:, None] \
            * landmarks[:, 0:5]
        landmarks[:, 5:10] = bounding_boxes[:, 1:2] + h[:, None] \
            * landmarks[:, 5:10]
        bounding_boxes = calibrate_box(bounding_boxes, offsets)
        keep = nms(bounding_boxes, nms_thresholds[2], mode="min")
        return bounding_boxes[keep], landmarks[keep]

    def _warp(self, img, lm):
        pts = [[lm[j], lm[j + 5]] for j in range(5)]
        return warp_and_crop_face(np.asarray(img), pts, self.reference,
                                  crop_size=(112, 112), device=self.device)

    def align(self, img):
        """The first face of the PIL image as a 112² aligned PIL crop, and
        its matrix; (None, None) when there is no face."""
        from PIL import Image
        _, landmarks = self.detect_faces(img)
        if len(landmarks) == 0:
            return None, None
        warped, tfm = self._warp(img, landmarks[0])
        return Image.fromarray(warped), tfm

    def align_multi(self, img, limit=None, min_face_size=30.0):
        """(boxes, 112² aligned PIL crops, matrices) of up to ``limit``
        faces."""
        from PIL import Image
        boxes, landmarks = self.detect_faces(img, min_face_size)
        if limit:
            boxes = boxes[:limit]
            landmarks = landmarks[:limit]
        faces, tfms = [], []
        for lm in landmarks:
            warped, tfm = self._warp(img, lm)
            faces.append(Image.fromarray(warped))
            tfms.append(tfm)
        return boxes, faces, tfms

    @staticmethod
    def show_bboxes(img, bounding_boxes, facial_landmarks=()):
        """A copy of the PIL image with the boxes and landmarks drawn."""
        from PIL import ImageDraw
        img = img.copy()
        draw = ImageDraw.Draw(img)
        for b in bounding_boxes:
            draw.rectangle([(b[0], b[1]), (b[2], b[3])], outline="white")
        for lm in facial_landmarks:
            for i in range(5):
                draw.ellipse([(lm[i] - 1, lm[i + 5] - 1),
                              (lm[i] + 1, lm[i + 5] + 1)], outline="blue")
        return img
