"""Context-parallel decode: flash-decoding across the ranks of a mesh axis.

Counterpart of ``leetcuda_tpu/parallel/cp_decode.py``. The KV caches split
on the sequence dim over ``axis`` ("sp") and the batch over "dp" (where the
mesh has it); q and lengths are split over "dp" and held whole on every
``axis`` rank. Each rank runs the port's decode kernel with its lse
(``attention/decode.py``, row 3; its plain version on CPU tensors) over its
slice with its local lengths, clip(lengths - idx * S_loc, 0, S_loc), and
the ranks' (out, lse) merge exactly, weights exp(lse - pmax(lse)) summed
over the axis (plain torch: JAX's pmax and psum are XLA's). A rank whose
local length is 0 writes zeros with an lse of -1e30, so its weight is 0.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.attention.decode import decode_attention
from leetcuda_tpu_torch.parallel.mesh import Mesh, pmax, psum, split


def make_decode_attention_cp(mesh: Mesh, axis: str = "sp", *,
                             block_k: int = 1024, sm_scale=None):
    """fn(q (B, H, D), k_cache, v_cache (B, Hkv, S, D), lengths (B,)) ->
    (B, H, D) in q's dtype, on the mesh's first device. ``block_k`` is the
    TPU's tiling and is accepted and ignored."""
    n_dp = mesh.shape.get("dp", 1)

    def fn(q, k_cache, v_cache, lengths):
        outs = []
        for d, (qd, kd, vd, ld) in enumerate(zip(
                *(torch.chunk(t, n_dp) for t in (q, k_cache, v_cache,
                                                 lengths)))):
            devs = mesh.axis_devices(axis, dp=d)
            ks, vs = split(kd, devs, 2), split(vd, devs, 2)
            s_loc = ks[0].shape[2]
            parts = [decode_attention(
                qd.to(dev), ks[i], vs[i],
                torch.clamp(ld.to(dev) - i * s_loc, 0, s_loc),
                sm_scale=sm_scale, with_lse=True)
                for i, dev in enumerate(devs)]
            lse = [p[1] for p in parts]
            m = pmax(lse)
            w = [torch.exp(l - mi) for l, mi in zip(lse, m)]
            num = psum([wi[..., None] * p[0].float()
                        for wi, p in zip(w, parts)])
            den = psum(w)
            outs.append((num[0] / torch.clamp(den[0], min=1e-30)[..., None])
                        .to(q.dtype).to(mesh.ranks()[0]))
        return torch.cat(outs)

    return fn
