"""Split-KV attention (flash-decoding): the keys cut into ``num_splits``
equal ranges, the flash forward with its lse over each, and the pieces
merged by ``merge_attn_states``.

Counterpart of ``leetcuda_tpu/attention/splitkv.py``: the same merge order
(a running merge that takes each next split as the suffix), non-causal
only, ``Nkv % num_splits == 0``. On CUDA tensors it runs ``num_splits``
launches of the flash forward with its lse (``csrc/flash_fwd.cu``: bf16,
head dim 64, 128 or 256) and ``num_splits - 1`` of the merge
(``csrc/merge_attn.cu``); on CPU tensors their plain versions. The flash
kernel takes contiguous keys, so each split's K and V slice is copied.
The merge works on the flash output's token-major view (B * Nq, H, D),
strided where B or Nq is 1 and a copy otherwise. ``block_q`` and
``block_k`` are the TPU's tiling and are accepted and ignored.
"""

from __future__ import annotations

from leetcuda_tpu_torch.attention.flash import flash_attention
from leetcuda_tpu_torch.ops.merge_attn_states import merge_attn_states


def flash_attention_splitkv(q, k, v, *, num_splits: int = 2,
                            block_q: int = 128, block_k: int = 256,
                            sm_scale=None):
    """Non-causal split-KV attention. q (B, H, Nq, D); k, v (B, Hkv, Nkv,
    D) -> (B, H, Nq, D)."""
    B, H, Nq, D = q.shape
    Nkv = k.shape[2]
    if num_splits < 1 or Nkv % num_splits:
        raise ValueError(f"flash_attention_splitkv: Nkv={Nkv} is not a "
                         f"multiple of num_splits={num_splits}")
    chunk = Nkv // num_splits

    def flat(o):  # (B, H, Nq, D) -> (B * Nq, H, D), token-major
        return o.transpose(1, 2).reshape(B * Nq, H, D)

    def flat_lse(lse):  # (B, H, Nq) -> (B * Nq, H)
        return lse.transpose(1, 2).reshape(B * Nq, H)

    merged_o = merged_l = None
    for s in range(num_splits):
        ks = k[:, :, s * chunk:(s + 1) * chunk].contiguous()
        vs = v[:, :, s * chunk:(s + 1) * chunk].contiguous()
        o_s, lse_s = flash_attention(q, ks, vs, sm_scale=sm_scale,
                                     with_lse=True)
        o_s, lse_s = flat(o_s), flat_lse(lse_s)
        if merged_o is None:
            merged_o, merged_l = o_s, lse_s
        else:
            merged_o, merged_l = merge_attn_states(merged_o, merged_l, o_s,
                                                   lse_s)
    return merged_o.reshape(B, Nq, H, D).transpose(1, 2)
