"""Ring attention (context parallelism) and Ulysses over the ranks of a
mesh axis.

Counterpart of ``leetcuda_tpu/parallel/ring.py``, with JAX's signatures:
q, k, v are the global (B, H, N, D) arrays, N split over ``axis``; the
result is the global (B, H, N, D) output, on the axis's first device. Each
rank's step is the port's flash kernel (``attention/flash.py``, row 1 of
the port's table; its plain version on CPU tensors); KV chunks hop the ring
and the ranks' values move as ``parallel/mesh.py``'s collectives move them
(plain torch, as JAX leaves ``ppermute`` and ``all_to_all`` to XLA).

Ring: after step s a rank holds the KV chunk of rank (r - s - 1) mod P, and
each step's (out, lse) merges into the running one by JAX's ``_merge`` (in
f32, the output cast back to q's dtype after every merge, as JAX's). Causal
attention needs no dynamic mask: a rank's own chunk is the diagonal
(causal), earlier chunks attend in full, and later ones are skipped (JAX
computes them and discards the result with ``jnp.where``; the function is
the same). Ulysses reshards sequence-split to head-split with one
all-to-all, runs full-sequence attention on each rank's heads and
reshards back; H and the KV heads must divide by P.

``block_q`` and ``block_k`` are the TPU's tiling and are accepted and
ignored.
"""

from __future__ import annotations

import torch

from leetcuda_tpu_torch.attention.flash import flash_attention
from leetcuda_tpu_torch.parallel.mesh import Mesh, all_to_all, ppermute, split


def _merge(o1, l1, o2, l2):
    """LSE-weighted merge of (B, H, Nloc, D) outputs with their (B, H, Nloc)
    f32 lses: JAX's ``_merge``, the merge-attn-states math."""
    m = torch.maximum(l1, l2)
    w1 = torch.exp(l1 - m)
    w2 = torch.exp(l2 - m)
    denom = w1 + w2
    out = (o1.float() * (w1 / denom)[..., None]
           + o2.float() * (w2 / denom)[..., None])
    return out.to(o1.dtype), m + torch.log(denom)


def ring_attention(q, k, v, mesh: Mesh, *, causal: bool = False,
                   axis: str = "sp", block_q: int | None = None,
                   block_k: int | None = None, sm_scale=None):
    """Exact attention over q/k/v (B, H, N, D) with N split on ``axis``:
    KV chunks rotate around the ring, each step's partial attention
    LSE-merged. A rank holds O(N / P) of q, k, v and the output."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    qs, kc, vc = (split(t, devs, 2) for t in (q, k, v))
    outs, lses = map(list, zip(*[
        flash_attention(qs[r], kc[r], vc[r], causal=causal,
                        sm_scale=sm_scale, with_lse=True)
        for r in range(n)]))
    for s in range(n - 1):
        kc, vc = ppermute(kc), ppermute(vc)
        for r in range(n):
            if causal and (r - s - 1) % n > r:
                continue  # a later chunk: masked out entirely
            o_s, l_s = flash_attention(qs[r], kc[r], vc[r],
                                       sm_scale=sm_scale, with_lse=True)
            outs[r], lses[r] = _merge(outs[r], lses[r], o_s, l_s)
    return torch.cat([o.to(devs[0]) for o in outs], 2)


def ulysses_attention(q, k, v, mesh: Mesh, *, causal: bool = False,
                      axis: str = "sp", block_q: int | None = None,
                      block_k: int | None = None, sm_scale=None):
    """DeepSpeed-Ulysses: all-to-all sequence-split -> head-split, full
    attention on each rank's heads, and back. One all-to-all each way
    instead of P - 1 ring hops; H and Hkv must divide by P."""
    devs = mesh.axis_devices(axis)
    qh, kh, vh = (all_to_all(split(t, devs, 2), 1, 2) for t in (q, k, v))
    oh = [flash_attention(a, b, c, causal=causal, sm_scale=sm_scale)
          for a, b, c in zip(qh, kh, vh)]
    return torch.cat([o.to(devs[0]) for o in all_to_all(oh, 2, 1)], 2)
