"""Greedy hard NMS in plain torch.

Counterpart of ``leetcuda_tpu/ops/nms.py`` (``_pairwise_iou``, ``nms``,
``nms_indices``, ``nms_ref`` and the ``hard_nms`` registration, ``ref``
None). JAX's version has no Pallas kernel: it is ``jnp`` plus a
``lax.fori_loop``, so the port keeps it as torch ops on the boxes' device,
with no kernel of its own.

The IoU matrix of the boxes in descending score order (a stable sort, as
``jnp.argsort``'s, so tied scores keep their input order) and the mask of
which box suppresses which later one are computed on the boxes' device and
packed there into bits, 8 to a byte. The host reads the packed mask back
once and walks it in score order: box i is kept iff no kept box before it
overlaps it by more than the threshold, and a kept box's row is OR-ed into
the set of suppressed boxes. This is the shape of py-faster-rcnn's
``gpu_nms`` (a bit mask on the device, one copy, a walk on the host). Its
cost is bounded whatever the boxes and scores: one transfer of
N * ceil(N / 8) bytes and N host steps, of which each kept box ORs one row
of ceil(N / 8) bytes. (A walk on the device takes N dependent steps of
device ops, and a fixed-point iteration of the keep vector as many
host-synchronised steps as the longest chain of suppressions, up to N.)
"""

from __future__ import annotations

import numpy as np
import torch

from leetcuda_tpu_torch.core.registry import register_op


def _pairwise_iou(boxes):
    """boxes (N, 4) [x1, y1, x2, y2] -> IoU matrix (N, N)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = torch.clamp(x2 - x1, min=0.0) * torch.clamp(y2 - y1, min=0.0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (torch.clamp(ix2 - ix1, min=0.0)
             * torch.clamp(iy2 - iy1, min=0.0))
    union = area[:, None] + area[None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def _order(scores):
    return torch.argsort(-scores, stable=True)


def _suppression_bits(boxes, order, iou_threshold):
    """Row j of the mask of box j (in score order) suppressing a later box
    i, packed little-endian: bit i % 8 of byte i // 8; (N, ceil(N / 8))
    uint8 on the boxes' device."""
    n = boxes.shape[0]
    iou = _pairwise_iou(boxes[order].float())
    sup = torch.triu(iou > iou_threshold, diagonal=1).to(torch.uint8)
    sup = torch.nn.functional.pad(sup, (0, -n % 8)).view(n, -(-n // 8), 8)
    shifts = torch.arange(8, dtype=torch.uint8, device=boxes.device)
    return (sup << shifts).sum(-1, dtype=torch.uint8)


def nms(boxes, scores, iou_threshold: float = 0.5):
    """Greedy hard-NMS. Returns a keep mask over boxes (in input order).

    Boxes are processed in descending score order; a box is kept iff its
    IoU with every previously kept box is <= threshold."""
    n = boxes.shape[0]
    order = _order(scores)
    rows = _suppression_bits(boxes, order, iou_threshold).cpu().numpy()
    keep = np.zeros(n, dtype=bool)
    suppressed = 0  # a bit set over the boxes in score order
    for i in range(n):
        if not suppressed >> i & 1:
            keep[i] = True
            suppressed |= int.from_bytes(rows[i].tobytes(), "little")
    out = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    out[order] = torch.from_numpy(keep).to(boxes.device)
    return out


def nms_indices(boxes, scores, iou_threshold: float = 0.5,
                max_out: int | None = None):
    """Kept indices in descending-score order (torchvision's return
    convention), padded with -1 to ``max_out`` (at most N)."""
    n = boxes.shape[0]
    max_out = max_out or n
    keep = nms(boxes, scores, iou_threshold)
    order = _order(scores)
    kept = order[keep[order]]
    out = torch.full((n,), -1, dtype=order.dtype, device=boxes.device)
    out[:kept.numel()] = kept
    return out[:max_out]


def nms_ref(boxes, scores, iou_threshold: float = 0.5):
    """Numpy greedy oracle in float64 (the reference's nms.cc analog): in
    descending score order (tied scores in input order, as ``nms`` takes
    them), a box is kept iff no kept box overlaps it by more than the
    threshold, each box's overlaps with the kept ones computed at once."""
    b = np.asarray(boxes, dtype=np.float64)
    s = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-s, kind="stable")
    keep = np.zeros(len(b), dtype=bool)
    area = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    taken = np.zeros(0, dtype=np.int64)
    for i in order:
        t = b[taken]
        iw = np.maximum(np.minimum(b[i, 2], t[:, 2])
                        - np.maximum(b[i, 0], t[:, 0]), 0)
        ih = np.maximum(np.minimum(b[i, 3], t[:, 3])
                        - np.maximum(b[i, 1], t[:, 1]), 0)
        inter = iw * ih
        union = area[i] + area[taken] - inter
        pos = union > 0
        if not np.any(inter[pos] / union[pos] > iou_threshold):
            keep[i] = True
            taken = np.append(taken, i)
    return keep


register_op(
    "hard_nms",
    ref=None, family="nms", tags=("greedy",),
)(nms)
