"""The per-stream scratch of the split kernels outlives its growth.

``gemm/quant.py _split_scratch`` (the w8a16 / w4a16 split-K workspace and
counters) and ``attention/decode.py _stream_counters`` (the split-KV decode
counters) keep one buffer set per (device, stream) and replace it by a
larger one when a later eager call needs more. A CUDA graph captured on the
stream before the growth still launches into the old buffers, so the old
ones must never be freed: these tests hold weak references to them across
a growth (on CPU tensors, with no capture in progress) and check that they
survive and that the new buffers are the larger ones.
``chip_smoke.py graph_scratch_check`` replays such a graph on the card.
"""

import gc
import weakref

import pytest
import torch

from leetcuda_tpu_torch.attention import decode as da
from leetcuda_tpu_torch.gemm import quant as gq

CPU = torch.device("cpu")


@pytest.fixture
def fresh(monkeypatch):
    """Empty scratch tables, restored afterwards; no capture in progress
    (this torch has no CUDA to ask)."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(gq, "_SPLIT_SCRATCH", {})
    monkeypatch.setattr(gq, "_SPLIT_RETIRED", [])
    monkeypatch.setattr(da, "_STREAM_COUNTERS", {})
    monkeypatch.setattr(da, "_RETIRED_COUNTERS", [])


@pytest.mark.usefixtures("fresh")
def test_split_scratch_keeps_what_growth_replaces():
    ws, cnt = gq._split_scratch(CPU, 7, 100, 10)
    refs = [weakref.ref(ws), weakref.ref(cnt)]
    assert gq._split_scratch(CPU, 7, 50, 10) == (ws, cnt)  # no growth
    del ws, cnt
    grown = gq._split_scratch(CPU, 7, 5000, 2000)
    gc.collect()
    assert all(r() is not None for r in refs)
    assert [id(t) for t in gq._SPLIT_RETIRED] == [id(r()) for r in refs]
    assert grown[0].numel() >= 5000 and grown[1].numel() >= 2000
    assert not grown[1].any()  # new counters start at zero
    # a buffer large enough is kept when the other one grows
    wider = gq._split_scratch(CPU, 7, 2 * grown[0].numel() + 1, 10)
    assert wider[1] is grown[1] and len(gq._SPLIT_RETIRED) == 3
    # another stream has its own pair; its first use retires nothing
    other = gq._split_scratch(CPU, 8, 100, 10)
    assert other[0] is not wider[0] and len(gq._SPLIT_RETIRED) == 3


@pytest.mark.usefixtures("fresh")
def test_stream_counters_keep_what_growth_replaces():
    buf = da._stream_counters(CPU, 7, 10)
    ref = weakref.ref(buf)
    assert buf.numel() == da._MIN_COUNTERS and not buf.any()
    assert da._stream_counters(CPU, 7, 100) is buf  # no growth
    del buf
    grown = da._stream_counters(CPU, 7, da._MIN_COUNTERS + 1)
    gc.collect()
    assert ref() is not None and da._RETIRED_COUNTERS == [ref()]
    assert grown.numel() == 2 * da._MIN_COUNTERS and not grown.any()


@pytest.mark.usefixtures("fresh")
@pytest.mark.parametrize("step", [1, 37, 1000])
def test_growth_step_by_step_retains_less_than_the_live_buffers(step):
    """Demand rising by ``step`` at a time: each growth at least doubles,
    so the retired buffers together hold less than the live one and the
    growths stay logarithmic in the demand."""
    for need in range(1, 20000, step):
        gq._split_scratch(CPU, 7, need, need // 4)
        da._stream_counters(CPU, 7, need)
    ws, cnt = gq._split_scratch(CPU, 7, 1, 1)
    retired = {dt: [t for t in gq._SPLIT_RETIRED if t.dtype == dt]
               for dt in (torch.float32, torch.int32)}
    assert sum(t.numel() for t in retired[torch.float32]) < ws.numel()
    assert sum(t.numel() for t in retired[torch.int32]) < cnt.numel()
    assert len(retired[torch.float32]) <= 15 and len(retired[torch.int32]) <= 3
    live = da._stream_counters(CPU, 7, 1)
    assert sum(b.numel() for b in da._RETIRED_COUNTERS) < live.numel()
    assert len(da._RETIRED_COUNTERS) <= 3


@pytest.mark.usefixtures("fresh")
def test_growth_refused_inside_a_capture(monkeypatch):
    gq._split_scratch(CPU, 7, 100, 10)
    da._stream_counters(CPU, 7, 10)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="before capturing"):
        gq._split_scratch(CPU, 7, 1000, 10)
    with pytest.raises(RuntimeError, match="before capturing"):
        da._stream_counters(CPU, 7, da._MIN_COUNTERS + 1)
    # what exists is handed out during a capture
    assert gq._split_scratch(CPU, 7, 100, 10)[0].numel() == 100
    assert gq._SPLIT_RETIRED == [] and da._RETIRED_COUNTERS == []
