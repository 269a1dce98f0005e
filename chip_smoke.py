#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (leetcuda_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Phases; any failure raises and the script exits non-zero:

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every kernel under leetcuda_tpu_torch/csrc/ (timed).
3. Kernel checks: each hand-written kernel against its plain PyTorch version
   on the card in bf16 at atol/rtol 1e-2, at the shapes of the main paths,
   with its time (CUDA events, L2 flushed before each launch), the plain
   version's time, one PyTorch library call's time as a yardstick, and the
   least time the card could take (bound). The quantized matmuls run on
   the quantized paths' own weights at every row count each path gives
   them, and are also run in both of their routes, each twice bit for bit,
   and timed. Paged attention
   runs over shuffled pools full of NaN wherever no row owns a position;
   the fused norm->QKV->RoPE and norm->matmul kernels run on layer 0 of
   path (d)'s params, beside the eager unfused sequence and the bare
   ``torch.matmul``. The split-KV decode kernel's own checks
   (``check_decode_split``): lengths on both sides of its split edges with
   NaN past them (and their lse), a window over e4m3 pools of 16, every
   row launched alone against its row in the batch, two launches back to
   back and a CUDA-graph capture replayed, each bit for bit, and path
   (t)'s cp-decode shape (a group of 8, lengths to 32768) timed beside
   SDPA. The chunk kernel's four entry points run at the
   verify shape (B = 8, T = 4) and at admission shapes (B = 1, T = 256 and
   1024), NaN in every position at or past base + T. The flash forward's
   lse (causal and ragged), then the FA-2 backward's dQ and dK/dV kernels
   at training's shape (8, 16, 2048, 128), 4 KV heads: causal, non-causal,
   head dim 64, with an lse cotangent, and with Gemma 2's options (a window
   of 512 with a softcap of 50, the cap alone, a window of 1000), and the
   TMA kernels' edges (BWD_EDGE_CASES: tiles past the end of a head at N =
   1000, groups of 1 and 8, Nq != Nk), by relative L2 error (BWD_REL_L2)
   and elementwise, a second call bit for bit and the delta that the dQ
   launch writes; beside them SDPA's backward (``torch.autograd.grad``;
   with a window over an explicit band mask) and the name of its longest
   kernel; the backward library's SASS (wgmma and TMA, no mma.sync). Then
   the TMA + wgmma flash forward's edges (FWD_EDGE_CASES: N = 1000 tiles
   that cross a head's end, groups of 1 and 8, Nq 1000 / Nk 1500
   non-causal, head dim 64, ragged batches with NaN in K and V past every
   length, whose output must stay finite), each a second time bit for bit,
   with the lse's control (log2 units) and the cap's (uncapped, cap /
   log2(e)) that must fail, and its SASS. The w4a16 matmul runs both of its
   routes (split-K at decode rows, 64- or 128-row tiles at prefill rows)
   at path (c)'s weight shapes and 1-1024 rows, each twice bit for bit,
   and its SASS (wgmma and TMA, no mma.sync); so does the w8a16 matmul
   (split-K at decode rows; at prefill rows a conversion pass, then the
   dense TMA + wgmma kernel) at paths (a) and (b)'s weight shapes and every
   row count of theirs (1-12288), with e4m3's NaN bytes on both routes;
   its conversion pass (``w8_to_bf16``, a kernel and a count of its own)
   is also held exact and timed alone against its byte bound.
   Path (o) runs its own phase 3
   (``check_attn_options``): the window and softcap of every attention
   kernel at Gemma-2-27B's layer-0 shapes; path (p) its own
   (``check_lse``): the lse of the decode, paged and chunk kernels at
   GPT-OSS-20B's; path (q) its own (``check_shared``): the shared-KV decode
   and paged kernels at DeepSeek-V2-Lite's; path (r) ``check_attn_options``
   again at head dim 256 (Gemma-2-9B's layer-0 shapes), each capped check
   beside a third control that must fail (the kernel at 128^-0.5), and the
   fused entry block on its fused layer 0; path (s) the backward at head
   dim 256 (``bwd_case`` at Gemma-2-2B's (1, 8, 8192, 256), 4 KV heads).
4. Main paths, each with the launch counts zeroed just before it and read
   just after, on the full-width default ModelConfig() (random bf16 weights
   from a seed, quantized on the card):
   bf16   the continuous-batching Engine serves 8 requests with prompts of
          16-1500 tokens admitted in one ragged batch, then one request
          alone (the forward path); then ``generate`` at B=8, S=128, 64 new
          tokens;
   (a)    the north star: the Engine over fused e4m3 weights and an e4m3 KV
          cache serves the same 8 requests and the lone one, 32 tokens each;
   (b)    ``generate`` over fused int8 weights and an int8 KV cache, B=8,
          S=128, 32 new tokens;
   (c)    ``generate`` over int4 weights and an int8 KV cache, the same.
   (d)    the paged Engine (pages of 128) over dense fused bf16 params
          serves the bf16 path's requests from a pool one page short of
          what they grow to, so that at least one sequence is preempted
          and recomputed; every decode step goes through the paged kernel
          and the fused norm->QKV->RoPE kernel, none through the
          contiguous decode kernel;
   (e)    the paged Engine over path (a)'s fused e4m3 packs and e4m3
          pools (the full default pool): the quantized paged kernel and
          w8a16, and no fused entry block (a pack is no dense ``wqkv``).
   (f)    the speculative Engine, greedy, spec_k = 3: target = path (d)'s
          dense fused bf16 params over paged bf16 pools, draft = path (a)'s
          e4m3 pack of the same weights on a contiguous bf16 cache (it
          agrees with the target on about two thirds of the positions, so
          ticks accept 0..3 proposals); the same 8 requests and the lone
          one. Every target tick is one T = 4 ``decode_chunk`` through the
          paged chunk kernel; no decode step of the target runs;
   (g)    the Engine with the prefix cache and ``prefill_chunk`` = 256 over
          path (a)'s packs and e4m3 pools: four requests sharing a
          1024-token prefix (suffixes of 16..400 tokens) stream in 256
          prompt tokens a tick beside the decode of those already live,
          then four more with the same prefix adopt its 8 pages each;
   (h)    ``speculative_generate`` at B=8, S=128, 32 tokens, k = 3, over
          contiguous bf16 caches with (f)'s target and draft; the
          speculative Engine over an int8 contiguous cache, 4 requests; one
          short ``speculative_sample_generate`` (temperature 0.8, top_k 50).
   (i)    training, on its own random params: one B=2, S=2048 step's loss
          and every gradient through the kernels, replayed with the
          model's attention swapped for the plain forward and backward
          (REPLAY_LOSS_TOL, REPLAY_GRAD_TOL), and for the kernel forward
          with the plain backward (REPLAY_BWD_TOL; each layer's backward
          kernels against the plain backward on its activations,
          REPLAY_CALL_TOL; a roundoff control); then 12 AdamW steps of
          ``make_train_step`` (remat, lr 3e-4) at B=8, S=2048 over crops of
          a permutation-walk corpus: finite losses that fall, each step
          launching the forward with its lse twice per layer and dQ and
          dK/dV once, nothing else; tokens/s and model-FLOP share after two
          warm-up steps, peak device memory.
   (j)    the GEMM library (after phase 3, before the serving paths), in
          three parts, each with the counts zeroed: every one of the 25
          registered ops at its ``make_args`` inputs against its plain
          version at its registry tolerance (hgemm_w8a8_i32 exactly); the
          headline, ``hgemm`` at bf16 and f16 8192^3 beside torch.matmul,
          the 12 rungs at 2048^3 in their dtypes, the JAX tests' ragged
          shapes (the swizzled rungs also where the group does not divide
          the tile columns); then the full-width model's shapes:
          ``matmul_auto`` at training's 16384 rows over layer 0's
          projections and the output projection, and at the skewed shapes
          of tests/test_gemm.py; ``gemv`` / ``hgemv`` of one decode row and
          ``rms_norm_gemv`` against layer 0's weights; the int8 matmul at
          8192^3 and on the projections' int8 packs beside torch._int_mm.
          Each case is held against its plain version (f32 at 1e-3, int8
          exactly) and timed beside it and the library call, with the
          launch counts left as they were (``uncounted``); at the headline
          and the matmul_auto shapes every tensor-core tile is timed with
          and without a grouped walk (the A/B behind pick_matmul_config),
          and at the gemv shapes each ``k_lanes``. The f16 / bf16 tiles are
          one persistent TMA + wgmma kernel: the library's SASS holds
          wgmma and TMA loads and no mma.sync.
   (k)    the row ops and split-KV attention (after path (j)), in three
          parts, each with the counts zeroed: the 27 registered ops of the
          rms-norm, layer-norm, softmax and attention-utils families at
          their ``make_args`` inputs against their registry oracles at
          their registry tolerances; then the full-width model's shapes:
          ``rms_norm`` with layer 0's attn_norm in bf16 at training's 16384
          rows and a decode step's 8, every rms-norm rung at 16384 rows in
          its dtype and at (4096, 2050) (a scalar tail, misaligned rows);
          ``layer_norm``, its backward (the rows route twice, bit for
          bit, and in turn with the block route) and
          ``layer_norm_trainable``'s gradients against autograd through
          the plain forward, at (16384, 2048) in bf16, f32 and f16 with
          random gamma and beta; the backward's block route at (4096, 2050)
          (twice, bit for bit); every layer-norm rung; rows offset by 1e3
          against float64; the three softmax forms in f32 at (2048, 32000) and (8,
          32000), every softmax rung at 16384 rows, and rows that overflow
          the naive form (NaN as its plain version); then
          ``flash_attention_splitkv`` in bf16 at decode (q (8, 16, 1, 128)
          over 2048 keys, 4 KV heads, num_splits 2, 4, 8) and prefill (q (1,
          16, 2048, 128), num_splits 2, 4) against the plain attention and
          the unsplit flash kernel (each call: num_splits flash forwards
          with their lse and num_splits - 1 merges, asserted), the flash
          forward with its lse at each split's key count against its plain
          version, and ``merge_attn_states`` alone at (2048, 16, 128) and
          with empty and NaN lse. Every call's inputs are checked
          unchanged; each timed case beside its plain version and
          F.rms_norm, F.layer_norm (and its autograd backward),
          torch.softmax or SDPA (the merge has no library call).
   (l)    the op corpus's transpose, embedding gathers, RoPE and resident
          matmul chain (after path (k)), in three parts, each with the
          counts zeroed: the 24 registered ops of the transpose, embedding,
          rope and gemm-resident families at their ``make_args`` inputs
          against their registry oracles at their registry tolerances;
          then, timed: the full-width model's embedding table (32000, 2048)
          bf16 gathered at training's 16384 ids and a decode step's 8,
          directly and through the serving view, and every embedding rung
          at 16384 ids in its dtype (bit for bit, beside F.embedding);
          every RoPE rung in f32 at (65536, 128) and (4096, 2048) at 1e-4
          (no library call); ``mat_transpose`` and every transpose rung at
          8192^2 f32 bit for bit beside ``x.t().contiguous()``; the
          resident chain (one persistent TMA + wgmma launch) at 4096^3
          bf16, 5 reps, at 2e-2 beside 5 torch.matmul (the library) and 5
          of the port's hgemm, with its TFLOP/s, share of the bound, grid
          and tile; then, untimed: every transpose rung at (4097, 3001) in
          f32, bf16 and bytes; ids that clamp (negative, past V - 1), NaN
          rows with distinct payloads and int64 ids, bit for bit; RoPE in
          bf16; the chain in f16 and f32 at 1024^2 and in bf16 and f32 at
          (1000, 1030), 1 and 4 reps, and in bf16 at (4097, 2048), 3 reps;
          reps 5 in one launch against 5 launches at reps 1 at 4096^3 and
          (1000, 1030), a second call and two replays of a CUDA graph, bit
          for bit; reps 5 against the plain chain at reps 4, which must
          miss 2e-2; the chain's SASS (wgmma and TMA, no mma.sync). Every
          call's inputs are checked unchanged.
   (m)    the op corpus's add, activations, reductions, dot product and
          histogram (after path (l)), in three parts, each with the counts
          zeroed: the 136 registered ops of the elementwise, activation,
          reduce, dot-product and histogram families at their
          ``make_args`` inputs against their registry oracles at their
          registry tolerances; then, timed: the bf16 residual add at
          training's (16384, 2048) bit for bit beside torch.add, swish and
          gelu in bf16 at its FFN hidden (16384, 5632) beside F.silu and
          F.gelu, the f32 max beside torch.amax, a histogram of training's
          (8, 2048) token ids over the 32000-token vocabulary beside
          torch.bincount, every add and activation rung at 4096^2 and every
          sum and dot rung and both histogram rungs at (16384, 2048) in
          their dtypes, and NMS (torch ops and a host walk, no kernel)
          over Faster R-CNN's 1000 and 6000 proposals, 6000 with ramped
          scores and a 6000-box suppression chain, keep-equal to nms_ref;
          then, untimed: every rung and the max at (700, 4000), (1300,
          2500), (3, 130), (1, 1) and one element off an aligned base;
          NaN, infinities and signed zeros through the add (bit for bit)
          and every activation (NaN where the plain version has it); NaN
          in the f32 sum and the max, e4m3's NaN bytes in its sum, an int8
          sum that wraps; every float sum, the max and every dot twice,
          bit for bit; histogram values outside the bins, dropped, at 128,
          32000 and 128256 bins (past the shared memory). Outside the
          registry sweep, a float sum or dot is held to one ulp of its
          accumulator plus f32 reordering (``flat_tol``). Every call's
          inputs are checked unchanged.
   (n)    MoE serving, run first (right after the build, on an empty card):
          Qwen3-30B-A3B (``qwen3_30b_a3b_config``: 48 layers, 32 / 4 heads
          of 128, 128 experts of 768, top-8 renormalized, vocab 151936) at
          its published width and depth, random bf16 weights built on the
          card from a seed (60.5 GB), dropless experts through the grouped
          matmul. Phase 3's gmm checks on its layer 0 (``check_gmm``: the
          decode and prefill products, each route's in turn, one expert,
          empty experts, ragged N, f32 and f16, beside torch._grouped_mm;
          NaN rows and K, N past 64s on both routes; the wgmma kernels'
          SASS); then the contiguous-cache
          Engine serves 8 requests with prompts of 16-1000 tokens admitted
          in one ragged batch and a lone 100-token request, then
          ``generate`` at B=8, S=128, 32 new tokens each: exactly 3 gmm
          launches per layer per forward, ragged forward and decode step,
          every one on the wgmma route (``gmm``, none on ``gmm_tile``);
          its phase 5 (every served token against a solo B=1 replay) and
          phase 6 (one B=8 decode step at context 1024, the gmm's share).
   (o)    Gemma-2-27B, run second (after (n), on the card emptied again):
          ``gemma2_27b_config`` (46 layers, hidden 4608, 32 / 16 heads of
          128, a 4096-token sliding window on the even layers, attention
          softcap 50, final softcap 30, vocab 256000) at its published
          width and depth, 27.2B random bf16 parameters built on the card
          from a seed. First its phase 3 on the empty card
          (``check_attn_options``): the flash forward at (1, 32, 8192, 128)
          for a local and a global layer, with and without its lse, and a
          window of 1000; the ragged forward; the band skip at 16384 rows
          (the windowed forward must take under BAND_SKIP_MAX of the causal
          one's time); decode over bf16, int8 and e4m3 caches and paged
          pools at lengths on both sides of the window, NaN past them; the
          chunk kernel with the cap at T=512 across the window's edge. Then
          the paged Engine (pages of 128, 4 slots of 6144, chunked prefill
          of 512 tokens a tick) serves prompts of 5120, 4000, 1024 and 300
          tokens, 128 new each (one admitted past the window, one crossing
          it while decoding), and a lone 700-token request; a contiguous
          Engine admits 1024 and 300 tokens in one ragged batch; then
          ``generate`` at B=4, S=256, 64 new tokens: exactly one attention
          launch per layer per forward, ragged forward, chunk and decode
          step, half of the calls windowed; every served token replayed
          solo through ``decode_chunk`` in chunks of 512 (phase 5); one B=4
          decode step at context 5120 profiled, the attention device time
          of the windowed and the global layers apart (phase 6).
   (p)    GPT-OSS-20B, run third (after (o), on the card emptied again):
          ``gpt_oss_20b_config`` (24 layers, hidden 2880, 64 / 8 heads of
          64, attention sinks, a 128-token window on the even layers, q/k/v/o
          biases, 32 experts of 2880 with 4 active in JAX's dense combine,
          vocab 201088, untied head) at its published width and depth,
          20.9B random bf16 parameters (41.8 GB) built on the card from a
          seed in the JAX loader's layout, the router given margins (see
          ``gptoss_path``). First its phase 3 (``check_lse``): the with_lse
          option of decode (bf16, int8, e4m3), paged (bf16, int8, e4m3 pools
          of 128) and chunk (T=4 and T=512 over the four layouts) at its
          layer-0 shapes (B=8, capacity 2048), a windowed and a global
          layer, lengths 0 / below / at / past the window, NaN past them:
          out and lse against the plain versions, each kernel timed with
          and without the lse, and two lse controls that must fail (the lse
          in log2 units; on a windowed layer, the unwindowed rows'). Then
          the paged Engine with ``prefill_chunk`` 256 over bf16 pools (4
          prompts of 200-640 tokens x 32) and int8 pools (2 x 16), a ragged
          admission over a contiguous cache, ``generate`` at B=8 and over an
          int8 cache at B=4: exactly one attention launch per layer per
          call, every one with the lse, half of them windowed; then
          ``speculative_generate`` and the speculative Engine over int8 KV
          with a 2-layer draft (every attention launch with the lse); every
          served token replayed solo (phase 5) beside a roundoff control
          (``forward`` against ``decode_chunk``) at the drawn and the served
          router; the logits of one prompt with and without the sinks (must
          move by more than LOGIT_TOL); one B=8 decode step at context 1024
          profiled and the dense combine timed alone (phase 6).
   (q)    DeepSeek-V2-Lite, run fourth (after (p), on the card emptied
          again): ``deepseek_v2_lite_config`` (27 layers, hidden 2048, 16
          heads, MLA with a 512 + 64 latent, 64 routed experts of 1408 with
          6 active and 2 shared in JAX's dense combine, vocab 102400, untied
          head, its YaRN rope_scaling dropped as the JAX package refuses
          it) at its published width and depth, 15.7B random bf16
          parameters (31.4 GB) built on the card from a seed. First its
          phase 3 (``check_shared``): the shared-KV decode and paged kernels
          at B=8, 16 heads over one latent head of 576 lanes, lengths
          1..2000 (bf16; int8 and e4m3 with an f32 query; paged over
          shuffled pages of 128 and 16), at 128 heads (B=2), with a window,
          a cap and the lse, NaN past every length, every output lane
          against the plain version at MLA's scale 1 / sqrt(192) beside a
          control at the default 1 / sqrt(576) that must fail; one unshared
          case at a GQA group of 7. Then a roundoff control (prefill
          against stepwise decode over one 128-token prompt), and, with the
          counts zeroed, ``mla_generate`` B=8 S=128 x 32 over a bf16 latent
          cache and 32-token decodes over int8 and e4m3 latent caches and
          paged bf16 and int8 pools (pages of 16, a shuffled PageManager):
          exactly one shared launch per layer per decode step, no flash,
          gmm, fused entry or unshared attention launch; every served
          token replayed through a solo ``mla_model_prefill`` (phase 5;
          the quantized streams also over their own cache type); one B=8
          decode step at context 1024 profiled and the dense combine timed
          alone (phase 6).
   (r)    Gemma-2-9B, run fifth (after (q), on the card emptied again):
          ``gemma2_9b_config`` (42 layers, hidden 3584, 16 / 8 heads of
          256, path (o)'s switches) at its published width and depth, 9.24B
          random bf16 parameters (18.5 GB), path (o)'s phases over it
          (``gemma_path(tag="r")``) with three differences: the decode and
          paged kernels are the wide ones (head dim 256, group 2); the
          Engines serve dense fused params (``fuse_params``), so every
          decode step of theirs runs the fused norm->QKV->RoPE kernel at
          Dh = 256, exactly once per layer (counted by
          ``fused_decode_steps``), while ``generate`` and the replays run
          the unfused params; phase 6 profiles a step over the fused ones.
   (s)    Gemma-2-2B trained, run sixth (after (r), on the card emptied
          again): ``gemma2_2b_config`` (26 layers, hidden 2304, 8 / 4 heads
          of 256, window 4096 on the even layers, caps 50 / 30) at its
          published width, depth and context, 2.61B random bf16
          parameters, norms at w = 0 (``gemma_train_path``). First its
          phase 3 (the backward kernels at (1, 8, 8192, 256), causal and
          with the window and cap, controls at BWD_CAP and a wrong
          scale); then one B=1, S=2048 step replayed against the plain
          attention (path (i)'s bounds); then ``make_train_step`` (remat,
          AdamW lr 3e-4) at B=1, S=8192, 2 warm-up and 4 timed steps:
          finite losses that fall, each step launching the forward with its
          lse twice per layer and dQ and dK/dV once, nothing else; s a
          step, tok/s, model-FLOP share (attention over each layer's band)
          and peak device memory.
   (t)    the parallel layer, run seventh (after (s), on the card emptied
          again), on meshes of 8 ranks on the one card (``parallel_path``):
          first the ring kernels (csrc/ring_p2p.cu) against their plain
          versions bit for bit at 2, 3 and 8 ranks, f32 / bf16 / int8 /
          e4m3 bytes (NaN bytes included), shards of 91-364 bytes and 0.25-1
          MiB, every rank's result and input checked, timed at 8 ranks
          over Qwen3-30B-A3B's K shard at context 32768 (4 MiB a rank) and
          64 MiB a rank (the launch alone, into buffers allocated once),
          a launch too large to stay resident refused and a ring with no
          spin budget raising (the card fine after); the attention kernels
          at the main path's shapes against their plain versions (a ring
          rank's flash step with its lse, a Ulysses rank's call, every
          rank's decode with its lse); then its main path: K and V of that
          context through ``ppermute_p2p`` and ``ring_all_gather_p2p``,
          ``collectives.run_all``, ``ring_attention`` (sp = 8) and
          ``ulysses_attention`` (sp = 4) at Qwen3-30B-A3B's attention width
          (B=1, N=32768, causal and not) against the single-device flash
          kernel, the context-parallel decode (sp = 8; dp = 2 x sp = 4)
          with whole ranks empty against the single-device decode kernel,
          each at KERNEL_TOL and every row's relative L2 under PAR_REL_L2,
          beside controls that must miss it (the merge at equal weights,
          the ring's last hop dropped, Ulysses' heads misrouted), and
          ``pipeline_forward`` of ModelConfig() at pp = 4 against
          ``forward`` at KERNEL_TOL.
   Paths bf16, (a)-(e), (n), (o), (p), (q) and (r) must stay under their
   weight-bandwidth ceilings; no serving path launches a training kernel, no serving or
   training path launches a GEMM library kernel, none but (k) a row-op
   kernel, none but (l) a kernel of path (l), none but (m) one of path (m)
   and none but (n) the grouped matmul.
5. Checks: every served token, teacher-forced against a solo B=1 replay of
   the same model and cache type: each must score within LOGIT_TOL of the
   replay's max logit. A prompt the Engine admitted in a ragged batch
   replays through a B=1 ``forward``; the bf16 path's lone request and its
   ``generate`` streams replay token by token through ``decode_step``. The
   main paths' decode steps replay as CUDA graphs of ``decode_step``
   (``StepGraphs``: the same kernels in the same order, without the host's
   launches); the first stream of each params set and cache type replays
   eagerly too and must give the same gaps bit for bit. Then
   ``graph_scratch_check``: a B=1 step of (b)'s int8 packs over an int8
   cache, captured, replays bit for bit as the eager step after eager
   calls on its stream grew the split-K workspace and the split-KV
   counters (the superseded buffers still held at the graph's addresses).
   Paths (d), (e) and (f) replay over a CONTIGUOUS cache with UNFUSED math,
   so the replay shares neither the paged, the fused nor the chunk kernel
   with them; (g) replays token by token through
   ``decode_step`` over a contiguous e4m3 cache (the shared prefix once),
   as its whole prompt went through the chunk kernel over quantized pools.
   Printed, not asserted: each quantized model's top-1 agreement and max
   |logit difference| against the bf16 model on one 512-token prompt, and
   the share of (f)'s and (h)'s greedy tokens equal to plain greedy
   decoding.
6. Profile: one B=8 decode step at context 1024 of the bf16 path (unfused
   params), of the same step over dense fused params (the fused kernel's
   A/B), of a paged step of path (d) and of path (a), and one speculative
   tick of path (f) (three draft steps, the draft's catch-up step and the
   T = 4 verify), and one training step of path (i): wall time and, from
   torch.profiler, device time by kernel (the device busy share); for the
   training step also by class (attention kernels, matmuls, the rest).

Prints the card line, path (j)'s headline line
({"hgemm_bf16_8192cubed_tflops": ..., "cublas_tflops": ..., "ratio": ...,
"card": ...}), a {"kernels": [...]} line, and last a {"ok": true,
"device": {...}} line; with ``--json PATH`` also writes every number it
measured to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# its datapath's peak: the tensor cores' for bf16 / f16 and int8, the CUDA
# cores' for f32 (the GEMM library computes f32 without TF32).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
F32_FLOP_PER_S = 67e12
PEAK_RATE = {torch.bfloat16: BF16_FLOP_PER_S, torch.float16: BF16_FLOP_PER_S,
             torch.float32: F32_FLOP_PER_S, torch.int8: INT8_OP_PER_S}
KERNEL_TOL = dict(atol=1e-2, rtol=1e-2)  # the flash registry bar
# Teacher-forced check: a served token must score within this of the solo
# replay's max logit. The random model's logits have unit scale (unit-rms
# final norm times unit-norm embedding rows); 0.25 is ~16 bf16 ulps at the
# usual max logit of ~4, room for bf16 rounding in differently shaped
# products (ragged B=8 prefill vs B=1 decode) and nowhere near a wrong token
# of a random model (the max stands ~1 above the typical logit).
LOGIT_TOL = 0.25
# The softcap's checks draw q at CAP_Q_SCALE x unit scale: the scaled scores
# (D = 128 at 144^-0.5 or 128^-0.5) then spread ~9.4 wide and reach ~40,
# where the cap of 50 moves a logit by tens. At unit scale they spread ~0.94
# wide, the cap moves a logit by < 1e-2 and an uncapped kernel passes
# KERNEL_TOL. Beside each capped check two controls must fail it: the
# kernel with no cap, and at cap / log2(e), which is what a kernel computes
# that caps the score after the log2(e) fold.
CAP_Q_SCALE = 10.0
LOG2E = math.log2(math.e)
# The backward is held at cap BWD_CAP over unit-scale q instead: at 10x q,
# dK sums terms 10x larger, and on an H100 the kernel's dK / dV differed
# from the plain one's by up to 0.0625 elementwise, past KERNEL_TOL, while
# within BWD_REL_L2. Cap 2 bends scores ~0.94 wide as cap 50 bends scores
# 25x as wide (c / cap = tanh(s / cap)).
BWD_CAP = 2.0
# The quantized paths (weights, KV cache) of phase 4.
QUANT_PATHS = {"a": ("fp8", True, "fp8"), "b": ("int8", True, "int8"),
               "c": ("int4", False, "int8")}
# The kernels each path must launch.
PATH_KERNELS = {
    "bf16": ("flash_attention", "flash_attention_ragged", "decode_attention"),
    "a": ("flash_attention", "flash_attention_ragged", "matmul_w8a16",
          "w8_to_bf16", "decode_attention_quantized"),
    "b": ("flash_attention", "matmul_w8a16", "w8_to_bf16",
          "decode_attention_quantized"),
    "c": ("flash_attention", "matmul_w4a16", "decode_attention_quantized"),
    "d": ("flash_attention", "flash_attention_ragged", "paged_attention",
          "fused_norm_qkv_rope"),
    "e": ("flash_attention", "flash_attention_ragged", "matmul_w8a16",
          "w8_to_bf16", "paged_attention_quantized"),
    "f": ("flash_attention", "flash_attention_ragged", "matmul_w8a16",
          "decode_attention", "paged_chunk_attention"),
    "g": ("matmul_w8a16", "paged_attention_quantized",
          "paged_chunk_attention_quantized"),
    "h": ("flash_attention", "flash_attention_ragged", "matmul_w8a16",
          "decode_attention", "chunk_attention", "chunk_attention_quantized"),
    "i": ("flash_attention_lse", "flash_attention_bwd_dq",
          "flash_attention_bwd_dkv"),
}
# Path (j), the GEMM library, in three parts: the registry sweep (which also
# reaches the quantized matmuls' registered rungs), the ladder with the
# headline, and the model's shapes.
PATH_KERNELS.update({
    "j1": ("matmul", "matmul_i8i8i32", "gemv", "matmul_w8a16",
           "matmul_w4a16"),
    "j2": ("matmul",),
    "j3": ("matmul", "matmul_i8i8i32", "gemv", "rms_norm_gemv")})
# Path (k), the row ops and split-KV attention, in three parts: the registry
# sweep of the four families, the model's shapes, and split-KV with the
# merge (the flash forward with its lse, once per split).
PATH_KERNELS.update({
    "k1": ("rms_norm", "layer_norm", "softmax", "merge_attn_states"),
    "k2": ("rms_norm", "layer_norm", "layer_norm_bwd", "layer_norm_bwd_block",
           "softmax"),
    "k3": ("flash_attention_lse", "merge_attn_states")})
# Path (l), the op corpus's transpose, embedding gathers, RoPE and resident
# matmul chain, in three parts: the registry sweep of the four families, the
# timed full-size cases, and the untimed checks.
PATH_KERNELS.update({
    "l1": ("transpose", "embedding", "embedding_tiled", "rope", "rope_lane",
           "matmul_resident"),
    "l3": ("transpose", "embedding", "embedding_tiled", "rope_lane",
           "matmul_resident")})
PATH_KERNELS["l2"] = PATH_KERNELS["l1"]
# Path (m), the op corpus's add, activations, reductions, dot product and
# histogram, in three parts: the registry sweep of the five families (the
# max has no registration), the timed full-size cases, the untimed checks.
PATH_KERNELS.update({
    "m1": ("elementwise_add", "activation", "block_all_reduce_sum",
           "dot_product", "histogram"),
    "m2": ("elementwise_add", "activation", "block_all_reduce_sum",
           "block_all_reduce_max", "dot_product", "histogram")})
PATH_KERNELS["m3"] = PATH_KERNELS["m2"]
# Path (n), MoE serving: Qwen3-30B-A3B's attention and dropless experts.
PATH_KERNELS["n"] = ("flash_attention", "flash_attention_ragged",
                     "decode_attention", "gmm")
# Path (o), Gemma-2-27B: the paged Engine with chunked prefill, a ragged
# admission over a contiguous cache, and generate.
PATH_KERNELS["o"] = ("flash_attention", "flash_attention_ragged",
                     "decode_attention", "paged_attention",
                     "paged_chunk_attention")
# Path (p), GPT-OSS-20B: every attention call carries the lse (sinks): the
# paged Engine with chunked prefill, a ragged admission over a contiguous
# cache, generate over bf16 and int8 caches.
PATH_KERNELS["p"] = ("flash_attention_lse", "decode_attention_lse",
                     "decode_attention_quantized_lse", "paged_attention_lse",
                     "paged_attention_quantized_lse",
                     "paged_chunk_attention_lse",
                     "paged_chunk_attention_quantized_lse")
# ... and its speculative part: speculative_generate over a bf16 cache and
# the speculative Engine over an int8 one, a 2-layer draft of the same model
PATH_KERNELS["p2"] = ("flash_attention_lse", "decode_attention_lse",
                      "chunk_attention_lse", "chunk_attention_quantized_lse")
# Path (q), DeepSeek-V2-Lite: the shared-KV decode and paged kernels over
# bf16, int8 and e4m3 latent caches and bf16 and int8 latent pools.
PATH_KERNELS["q"] = ("decode_attention_shared",
                     "decode_attention_quantized_shared",
                     "paged_attention_shared",
                     "paged_attention_quantized_shared")
# Path (r), Gemma-2-9B at head dim 256: path (o)'s kernels, and the fused
# entry block of the Engine's decode steps over dense fused params.
PATH_KERNELS["r"] = PATH_KERNELS["o"] + ("fused_norm_qkv_rope",)
# Path (s), Gemma-2-2B trained at head dim 256: training's kernels.
PATH_KERNELS["s"] = PATH_KERNELS["i"]
# The kernels of training (paths (i) and (s)): no serving path launches them.
TRAIN_KERNELS = PATH_KERNELS["i"]
# The GEMM library's kernels: no serving or training path launches them (the
# model's projections are torch.matmul, as the JAX model left them to XLA).
GEMM_KERNELS = PATH_KERNELS["j3"]
# The row ops' kernels: no serving, training or GEMM path launches them (the
# model leaves its norms and softmax to eager PyTorch, as the JAX model left
# them to XLA).
ROW_KERNELS = PATH_KERNELS["k1"] + ("layer_norm_bwd",
                                     "layer_norm_bwd_block")
# The op corpus's kernels of path (l): no other path launches them (the
# model's embedding is an indexing op and its RoPE the half rotation, as the
# JAX model's are; nothing calls the resident chain).
CORPUS_KERNELS = PATH_KERNELS["l1"]
# The kernels of path (m): no other path launches them (the model leaves its
# activations, residual adds and loss reductions to eager PyTorch, as the
# JAX model leaves them to XLA).
FLAT_KERNELS = PATH_KERNELS["m2"]
# The grouped matmul: no path but (n) launches it (no other model has
# experts).
MOE_KERNELS = ("gmm", "gmm_tile")
# The kernels a path must NOT launch: a paged path never reads a contiguous
# cache, and a quantized pack is no dense ``wqkv`` for the fused block. A
# speculative target takes no decode step, a chunk-prefilled prompt no flash
# kernel, and each chunk path only its own cache layout's entry point.
PATH_FORBIDDEN = {
    "d": ("decode_attention", "decode_attention_quantized",
          "paged_attention_quantized"),
    "e": ("decode_attention", "decode_attention_quantized",
          "paged_attention", "fused_norm_qkv_rope"),
    "f": ("paged_attention", "paged_attention_quantized",
          "decode_attention_quantized", "chunk_attention",
          "chunk_attention_quantized", "paged_chunk_attention_quantized"),
    "g": ("flash_attention", "flash_attention_ragged", "decode_attention",
          "decode_attention_quantized", "paged_attention", "chunk_attention",
          "chunk_attention_quantized", "paged_chunk_attention"),
    "h": ("paged_attention", "paged_attention_quantized",
          "paged_chunk_attention", "paged_chunk_attention_quantized"),
    # bf16 weights over a contiguous bf16 cache; the q/k norms keep the
    # fused entry block away (and an MoE layer has nothing to fuse); every
    # gmm launch takes the wgmma route
    "n": ("decode_attention_quantized", "paged_attention",
          "paged_attention_quantized", "chunk_attention",
          "chunk_attention_quantized", "paged_chunk_attention",
          "paged_chunk_attention_quantized", "matmul_w8a16", "matmul_w4a16",
          "fused_norm_qkv_rope", "gmm_tile"),
    # bf16 weights (unfused) over bf16 caches and pools; chunked prefill
    # over pools only
    "o": ("decode_attention_quantized", "paged_attention_quantized",
          "chunk_attention", "chunk_attention_quantized",
          "paged_chunk_attention_quantized", "matmul_w8a16", "matmul_w4a16",
          "fused_norm_qkv_rope"),
    # the same with the Engine over dense fused bf16 params
    "r": ("decode_attention_quantized", "paged_attention_quantized",
          "chunk_attention", "chunk_attention_quantized",
          "paged_chunk_attention_quantized", "matmul_w8a16", "matmul_w4a16"),
    # attention sinks: no attention launch without the lse; bf16 weights;
    # chunked prefill over pools only
    "p": ("flash_attention", "flash_attention_ragged", "decode_attention",
          "decode_attention_quantized", "paged_attention",
          "paged_attention_quantized", "chunk_attention",
          "chunk_attention_quantized", "paged_chunk_attention",
          "paged_chunk_attention_quantized", "chunk_attention_lse",
          "chunk_attention_quantized_lse", "matmul_w8a16", "matmul_w4a16",
          "fused_norm_qkv_rope"),
    # contiguous caches only
    "p2": ("flash_attention", "flash_attention_ragged", "decode_attention",
           "decode_attention_quantized", "paged_attention",
           "paged_attention_quantized", "chunk_attention",
           "chunk_attention_quantized", "paged_chunk_attention",
           "paged_chunk_attention_quantized", "paged_attention_lse",
           "paged_attention_quantized_lse", "paged_chunk_attention_lse",
           "paged_chunk_attention_quantized_lse", "matmul_w8a16",
           "matmul_w4a16", "fused_norm_qkv_rope"),
    # MLA: the prefill is the expanded einsum form (no flash kernel), the
    # experts JAX's dense combine (no gmm, which drive forbids anyway), no
    # fused entry block, and every attention launch a shared one
    "q": ("flash_attention", "flash_attention_ragged", "flash_attention_lse",
          "decode_attention", "decode_attention_lse",
          "decode_attention_quantized", "decode_attention_quantized_lse",
          "paged_attention", "paged_attention_lse",
          "paged_attention_quantized", "paged_attention_quantized_lse",
          "chunk_attention", "chunk_attention_quantized",
          "paged_chunk_attention", "paged_chunk_attention_quantized",
          "chunk_attention_lse", "chunk_attention_quantized_lse",
          "paged_chunk_attention_lse", "paged_chunk_attention_quantized_lse",
          "decode_attention_shared_lse",
          "decode_attention_quantized_shared_lse",
          "paged_attention_shared_lse",
          "paged_attention_quantized_shared_lse", "matmul_w8a16",
          "matmul_w4a16", "fused_norm_qkv_rope"),
}
# (Training, path (i), has no list: ``train`` asserts each step's launches
# exactly, the training kernels and nothing else.)
# The backward kernels against their plain version: relative L2 error per
# gradient. One bf16 rounding is 2^-9 relative; P and dS are rounded to bf16
# on both sides, so the two differ by f32 summation order (dK and dV sum
# 2048 q rows x 4 heads of the group) and by ties that round P or dS one bf16
# ulp apart: well under 1e-2, where a wrong mask, scale or fragment gives
# O(1).
BWD_REL_L2 = 1e-2
# Path (i): the full-width model trains at B=8, S=2048 (train_bench's
# shape), 12 AdamW steps at lr 3e-4 under remat, timed after 2 warm-up
# steps, on crops of a learnable corpus. First one B=2 step is replayed
# with the plain attention forward and backward: the losses must agree
# within REPLAY_LOSS_TOL, relative, and each parameter's gradient by
# relative L2 error within REPLAY_GRAD_TOL. It is replayed once more with
# the kernel forward and the plain backward, so that only the backward
# kernels differ: each gradient within REPLAY_BWD_TOL of that run, and the
# backward kernels of each layer within REPLAY_CALL_TOL of the plain
# backward on that layer's own activations. The gradient gaps are roundoff
# grown through 16 layers of bf16 backward: nudging the lse by a few f32
# ulps in the plain backward alone moves layer 0's gradients by 0.0142 on
# an H100
# (the backward kernels: 0.0141; layer 15's wq: 6e-4), and the kernel
# forward's own bf16 O adds the rest of the 0.026 against the plain forward.
# So REPLAY_GRAD_TOL and REPLAY_BWD_TOL sit at ~2x those readings, and
# REPLAY_CALL_TOL at 4x the per-layer kernels' worst (5.0e-4), the bar that
# a fault on model-shaped inputs (a nearly flat P at init) would cross.
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 8, 2048, 12, 2, 3e-4
REPLAY_B, REPLAY_LOSS_TOL = 2, 1e-3
REPLAY_GRAD_TOL, REPLAY_BWD_TOL, REPLAY_CALL_TOL = 5e-2, 3e-2, 2e-3
PAGE = 128  # page size of the paged paths: the engine's default
SPEC_K = 3  # draft proposals per tick of the speculative paths
# Path (g): a shared prefix of 8 pages, then two waves of suffix lengths,
# prefilled 256 prompt tokens a tick.
PREFIX_LEN, PREFILL_CHUNK = 1024, 256
PREFIX_WAVES = ((16, 144, 272, 400), (16, 48, 80, 112))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, flush, iters=20, warmup=3, prep=None):
    """Median of per-launch CUDA-event times, L2 flushed before each;
    ``prep`` (if given) runs before every call, outside the window."""
    for _ in range(warmup):
        if prep:
            prep()
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for i in range(iters):
        flush.zero_()  # a 256 MB write evicts the 50 MB L2
        if prep:
            prep()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in zip(starts, ends)]))


def bound(flops, nbytes, rate=BF16_FLOP_PER_S):
    """The least time for ``flops`` operations at the datapath's peak
    ``rate`` and ``nbytes`` at the memory rate, and which of the two it is."""
    t_ops, t_bytes = flops / rate, nbytes / HBM_BYTES_PER_S
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes"))


def sdpa(q, k, v, **kw):
    """One PyTorch library call as the yardstick (never used by the port)."""
    import torch.nn.functional as F
    try:
        return F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    except TypeError:  # older torch: no enable_gqa
        g = q.shape[1] // k.shape[1]
        return F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1), **kw)


def matmul_cases(qparams, path_rows):
    """The quantized matmuls of the main paths: (path, weight key, pack, row
    counts) for each distinct weight shape in layer 0 of each path's params,
    the largest weight first, with the row counts the path gives it."""
    cases = []
    for path, m_rows in path_rows.items():
        packs = {}
        for key, w in qparams[path]["layers"][0].items():
            if isinstance(w, dict):
                packs.setdefault(tuple(w["q4" if "q4" in w else "q"].shape),
                                 (key, w))
        for shape, (key, w) in sorted(packs.items(),
                                      key=lambda kv: -kv[0][0] * kv[0][1]):
            cases.append((path, key, w, sorted(m_rows)))
    return cases


# The decode and paged checks' batch: B = 8, H = 16, Hkv = 4, D = 128 over a
# capacity of 2048 positions, lengths spread from 1 to 2000.
DECODE_LENS = np.array([1, 100, 517, 1024, 1200, 1400, 1950, 2000], np.int32)


def hold(got, want, tol=KERNEL_TOL):
    """Assert ``got`` close to ``want`` at ``tol`` (integers: equal) and
    return the largest absolute difference."""
    if not got.dtype.is_floating_point:
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"integer result differs from the plain "
                                 f"version ({got.dtype}, {want.dtype})")
        return 0.0
    torch.testing.assert_close(got.float(), want.float(), **tol)
    return float((got.float() - want.float()).abs().max())


class Recorder:
    """Phase 3's seeded inputs and its rows: one per check, the kernel's
    result held against its plain version at KERNEL_TOL."""

    def __init__(self, dev="cuda"):
        self.dev = dev
        self.rng = np.random.default_rng(0)
        self.rows = {}

    def randn(self, *shape, scale=1.0):
        return torch.from_numpy(
            self.rng.standard_normal(shape, dtype=np.float32)
            * scale).to(self.dev, torch.bfloat16)

    def record(self, check, name, src, replaces, got, want, ms, plain_ms,
               lib_ms, flops, nbytes, tol=KERNEL_TOL, rate=BF16_FLOP_PER_S):
        err = hold(got, want, tol)
        b_s, by = bound(flops, nbytes, rate)
        self.rows[check] = {
            "check": check, "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_s * 1e3,
            "bound_by": by, "library_ms": lib_ms,
            "flops": flops, "bytes": nbytes}

    def cap_controls(self, check, run, want, cap, wrong_scale=None):
        """Beside the capped check ``check``: ``run(c)`` launches its kernel
        at cap ``c``. Uncapped and at cap / log2(e) it must fail KERNEL_TOL
        against ``want``, the capped plain result (NaN fails too); with
        ``wrong_scale``, so must ``run(cap, wrong_scale)``, the kernel at
        another attention scale. Records the largest differences."""
        errs = {}
        runs = [("uncapped", lambda: run(None)),
                ("log2 domain", lambda: run(cap / LOG2E))]
        if wrong_scale is not None:
            runs.append((f"scale {wrong_scale:.4g}",
                         lambda: run(cap, wrong_scale)))
        for label, launch in runs:
            got, ref = launch().float(), want.float()
            errs[label] = float((got - ref).abs().max())
            if torch.allclose(got, ref, **KERNEL_TOL):
                raise AssertionError(f"{check}: the kernel {label} passes "
                                     f"the capped check")
        self.rows[check]["cap_controls"] = errs


def to_pool(cache, page, table, owned, fill):
    """Scatter a contiguous (B, Hkv, S[, D]) cache into a pool of
    B * S / page + 1 pages filled with ``fill``: logical page i of row b
    goes to physical page ``table[b, i]`` where ``owned[b, i]``."""
    from leetcuda_tpu_torch.core.runtime import as_bytes

    B, Hkv, S = cache.shape[:3]
    P = S // page
    chunks = as_bytes(cache).reshape(B, Hkv, P, page, *cache.shape[3:])
    chunks = chunks.transpose(1, 2)          # (B, P, Hkv, page[, D])
    pool = torch.full((B * P + 1, Hkv, page, *cache.shape[3:]), fill,
                      dtype=chunks.dtype, device=cache.device)
    pool[table[owned].long()] = chunks[owned]
    return pool.view(cache.dtype)


def shuffled_table(rng, n_pages, P, dev):
    """A block table (B, P) whose row b owns its first ``n_pages[b]`` logical
    pages, on physical pages drawn without repeat from 1..B * P; filler 0.
    Returns (table, owned) on ``dev``."""
    B = len(n_pages)
    owned = torch.from_numpy(np.arange(P)[None, :] < n_pages[:, None])
    table = torch.zeros((B, P), dtype=torch.int32)
    table[owned] = torch.from_numpy(rng.permutation(
        np.arange(1, B * P + 1))[:int(n_pages.sum())].astype(np.int32))
    return table.to(dev), owned.to(dev)


def check_paged(rec, flush):
    """Paged attention, plain and quantized pools, at the decode check's
    batch with pages of 128 and 16. Physical pages are shuffled; every
    position no row owns (page 0, unowned pages, the tail of each last
    page) holds NaN values and NaN scales (e4m3: the NaN byte 0x7F), and
    the table's filler is 0. Library yardstick: SDPA over the cache
    gathered (and dequantized) beforehand."""
    from leetcuda_tpu_torch.attention import paged as pg
    from leetcuda_tpu_torch.core.runtime import as_bytes
    from leetcuda_tpu_torch.models.llama import _quantize_token_kv

    dev, bf = rec.dev, torch.bfloat16
    B, H, Hkv, S, D = 8, 16, 4, 2048, 128
    lens_np = DECODE_LENS
    lengths = torch.from_numpy(lens_np).to(dev)
    n_valid = int(lens_np.sum())
    q = rec.randn(B, H, D)
    dmask = (torch.arange(S, device=dev)[None, :]
             < lengths[:, None])[:, None, None, :]
    past = ~(torch.arange(S, device=dev)[None, :]
             < lengths[:, None])[:, None, :].expand(B, Hkv, S)

    for page in (PAGE, 16):
        P = S // page
        n_pages = -(-lens_np // page)
        table, owned = shuffled_table(rec.rng, n_pages, P, dev)
        tbl_bytes = 4.0 * int(n_pages.sum())

        kc, vc = rec.randn(B, Hkv, S, D), rec.randn(B, Hkv, S, D)
        kc[past], vc[past] = float("nan"), float("nan")
        kp = to_pool(kc, page, table, owned, float("nan"))
        vp = to_pool(vc, page, table, owned, float("nan"))
        args = (q, kp, vp, table, lengths)
        got = pg.paged_attention(*args)
        if not torch.isfinite(got).all():
            raise AssertionError("paged kernel read a position no row owns")
        kg, vg = pg._gather(kp, table), pg._gather(vp, table)
        rec.record(f"paged_attention/page{page}", "paged_attention",
                   DECODE_SRC,
                   "leetcuda_tpu/attention/paged.py:232", got,
                   pg.paged_attention_plain(*args),
                   time_ms(lambda: pg.paged_attention(*args), flush),
                   time_ms(lambda: pg.paged_attention_plain(*args), flush,
                           iters=5),
                   time_ms(lambda: sdpa(q[:, :, None], kg, vg,
                                        attn_mask=dmask), flush),
                   4.0 * H * D * n_valid,
                   2.0 * (2 * Hkv * n_valid * D + 2 * B * H * D) + 4 * B
                   + tbl_bytes)

        for fmt, qdt in (("fp8", torch.float8_e4m3fn), ("int8", torch.int8)):
            kq, ks = _quantize_token_kv(rec.randn(B, Hkv, S, D), qdt)
            vq, vs = _quantize_token_kv(rec.randn(B, Hkv, S, D), qdt)
            ks[past], vs[past] = float("nan"), float("nan")
            nan_byte = 0x7F if fmt == "fp8" else 0
            as_bytes(kq)[past], as_bytes(vq)[past] = nan_byte, nan_byte
            pools = [to_pool(c, page, table, owned, f) for c, f in (
                (kq, nan_byte), (vq, nan_byte), (ks, float("nan")),
                (vs, float("nan")))]
            qargs = (q, *pools, table, lengths)
            got = pg.paged_attention_quantized(*qargs)
            if not torch.isfinite(got).all():
                raise AssertionError("quantized paged kernel read a position "
                                     "no row owns")
            kd = (pg._gather(pools[0], table).float()
                  * pg._gather(pools[2], table)[..., None]).to(bf)
            vd = (pg._gather(pools[1], table).float()
                  * pg._gather(pools[3], table)[..., None]).to(bf)
            rec.record(
                f"paged_attention_quantized/{fmt}/page{page}",
                "paged_attention_quantized",
                DECODE_SRC,
                "leetcuda_tpu/attention/paged.py:232", got,
                pg.paged_attention_quantized_plain(*qargs),
                time_ms(lambda: pg.paged_attention_quantized(*qargs), flush),
                time_ms(lambda: pg.paged_attention_quantized_plain(*qargs),
                        flush, iters=5),
                time_ms(lambda: sdpa(q[:, :, None], kd, vd, attn_mask=dmask),
                        flush),
                4.0 * H * D * n_valid,
                2 * Hkv * n_valid * D + 8.0 * Hkv * n_valid
                + 4.0 * B * H * D + 4 * B + tbl_bytes)


# The split-KV decode kernel's own checks (``check_decode_split``): the
# decode check's batch at lengths on both sides of the split edges (filled in
# from attention/decode.py SPLIT_KEYS[128]: 0, 1, L - 1, L, L + 1, 2L - 1,
# 2L + 1 and the capacity), a window of SPLIT_WINDOW keys (its band ends
# inside a split), and path (t)'s cp-decode shape: Qwen3-30B-A3B's 32 / 4
# heads of 128 (a group of 8) at B=8 over 32768 positions.
DECODE_SRC = "leetcuda_tpu_torch/csrc/decode_attn.cu"
SPLIT_WINDOW = 300
CP_DECODE_S = 32768
CP_DECODE_LENS = np.array([1, 100, 4095, 4097, 10000, 20000, 30000, 32768],
                          np.int32)


def same_bits(what, got, want):
    """Assert two kernel results equal bit for bit (NaN payloads too)."""
    if got.dtype != want.dtype or got.shape != want.shape \
            or not torch.equal(as_u8(got), as_u8(want)):
        raise AssertionError(f"{what}: not bit for bit equal")


def check_decode_split(rec, flush):
    """Phase 3: what the split-KV design adds to rows 3-5. At B=8, 16 / 4
    heads of 128 over 2048 positions, lengths on both sides of the split
    edges with NaN past every length: decode over a bf16 cache (and its
    lse), and with a window of SPLIT_WINDOW over shuffled e4m3 pools of 16,
    each against its plain version. Then, bit for bit on the card: every row
    launched alone against its row in the batch (contiguous and paged); two
    back-to-back launches; one CUDA-graph capture replayed twice, and an
    eager launch after it (the arrival counters zeroed again each time,
    nothing read on the host inside the capture). Last, path (t)'s
    cp-decode shape (B=8, 32 / 4 heads of 128, lengths CP_DECODE_LENS up to
    32768) with its lse, timed beside SDPA. The first row keeps the
    seconds the whole check took (``check_s``)."""
    from leetcuda_tpu_torch.attention import decode as dec
    from leetcuda_tpu_torch.attention import paged as pg
    from leetcuda_tpu_torch.core.runtime import as_bytes
    from leetcuda_tpu_torch.models.llama import _quantize_token_kv

    t0 = time.perf_counter()
    dev, bf = rec.dev, torch.bfloat16
    B, H, Hkv, S, D = 8, 16, 4, 2048, 128
    L = dec.SPLIT_KEYS[D]
    lens_np = np.array([0, 1, L - 1, L, L + 1, 2 * L - 1, 2 * L + 1, S],
                       np.int32)
    lengths = torch.from_numpy(lens_np).to(dev)
    cols = torch.arange(S, device=dev)[None, :]
    past = (cols >= lengths[:, None])[:, None, :].expand(B, Hkv, S)
    q = rec.randn(B, H, D)
    kc, vc = rec.randn(B, Hkv, S, D), rec.randn(B, Hkv, S, D)
    k0, v0 = kc.clone(), vc.clone()
    kc[past], vc[past] = float("nan"), float("nan")
    n_valid = int(lens_np.sum())
    mask = ~past[:, :1, None, :]
    args = (q, kc, vc, lengths)
    edges = f"decode_attention_lse/split edges L={L}"
    lse_case(rec, flush, edges, "decode_attention_lse", DECODE_SRC,
             "leetcuda_tpu/attention/decode.py:223", dec.decode_attention,
             dec.decode_attention_plain, args, {}, 4.0 * H * D * n_valid,
             2.0 * (2 * Hkv * n_valid * D + 2 * B * H * D) + 4 * B,
             4.0 * B * H, lambda: sdpa(q[:, :, None], k0, v0,
                                       attn_mask=mask))
    rec.rows[edges]["lengths"] = lens_np.tolist()

    # e4m3 pools of 16 with a window: NaN bytes past the lengths, NaN
    # wherever no row owns a position
    page, W = 16, SPLIT_WINDOW
    kq, ks = _quantize_token_kv(k0, torch.float8_e4m3fn)
    vq, vs = _quantize_token_kv(v0, torch.float8_e4m3fn)
    ks[past], vs[past] = float("nan"), float("nan")
    as_bytes(kq)[past], as_bytes(vq)[past] = 0x7F, 0xFF
    n_pages = -(-lens_np // page)
    table, owned = shuffled_table(rec.rng, n_pages, S // page, dev)
    pools = [to_pool(c, page, table, owned, f) for c, f in (
        (kq, 0x7F), (vq, 0xFF), (ks, float("nan")), (vs, float("nan")))]
    qargs = (q, *pools, table, lengths)
    got = pg.paged_attention_quantized(*qargs, window=W)
    if not torch.isfinite(got).all():
        raise AssertionError("split edges: NaN padding reached the output")
    band = (cols < lengths[:, None]) & (cols >= lengths[:, None] - W)
    n_band = int(band.sum())
    kd = (kq.float() * ks.nan_to_num()[..., None]).nan_to_num().to(bf)
    vd = (vq.float() * vs.nan_to_num()[..., None]).nan_to_num().to(bf)
    check = f"paged_attention_quantized/fp8 page{page} W{W} split edges"
    rec.record(check, "paged_attention_quantized", DECODE_SRC,
               "leetcuda_tpu/attention/paged.py:232", got,
               pg.paged_attention_quantized_plain(*qargs, window=W),
               time_ms(lambda: pg.paged_attention_quantized(*qargs, window=W),
                       flush),
               time_ms(lambda: pg.paged_attention_quantized_plain(
                   *qargs, window=W), flush, iters=5),
               time_ms(lambda: sdpa(q[:, :, None], kd, vd,
                                    attn_mask=band[:, None, None, :]),
                       flush),
               4.0 * H * D * n_band,
               2 * Hkv * n_band * D + 8.0 * Hkv * n_band + 4.0 * B * H * D
               + 4 * B + 4.0 * int(n_pages.sum()))
    rec.rows[check].update(lengths=lens_np.tolist(), window=W)
    del kd, vd

    # bit for bit: a row alone against its row in the batch
    bf_pools = [to_pool(c, page, table, owned, float("nan"))
                for c in (kc, vc)]
    batch = {"decode": dec.decode_attention(q, kc, vc, lengths,
                                            with_lse=True),
             "paged": pg.paged_attention(q, *bf_pools, table, lengths,
                                         with_lse=True)}
    for b in range(B):
        sl = slice(b, b + 1)
        alone = {"decode": dec.decode_attention(
                     q[sl], kc[sl], vc[sl], lengths[sl], with_lse=True),
                 "paged": pg.paged_attention(
                     q[sl], *bf_pools, table[sl], lengths[sl],
                     with_lse=True)}
        for form, (o, l) in alone.items():
            same_bits(f"{form} row {b} alone", o, batch[form][0][sl])
            same_bits(f"{form} row {b} alone (lse)", l, batch[form][1][sl])

    # two launches back to back, a graph replayed, an eager launch after it
    def run():
        return dec.decode_attention(q, kc, vc, lengths, with_lse=True)
    first, second = run(), run()
    same_bits("second launch", second[0], first[0])
    same_bits("second launch (lse)", second[1], first[1])
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run()  # the stream's counters, made outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        static = run()
    for i in range(2):
        graph.replay()
        torch.cuda.synchronize()
        same_bits(f"graph replay {i}", static[0], first[0])
        same_bits(f"graph replay {i} (lse)", static[1], first[1])
    after = run()
    same_bits("eager after the replays", after[0], first[0])
    del graph, static, bf_pools, pools, kc, vc, k0, v0

    # path (t)'s cp-decode shape, with the lse, beside SDPA
    H, Hkv, S = 32, 4, CP_DECODE_S
    lens_np = CP_DECODE_LENS
    B = len(lens_np)
    lengths = torch.from_numpy(lens_np).to(dev)
    cols = torch.arange(S, device=dev)[None, :]
    past = (cols >= lengths[:, None])[:, None, :].expand(B, Hkv, S)
    q = rec.randn(B, H, D)
    kc, vc = rec.randn(B, Hkv, S, D), rec.randn(B, Hkv, S, D)
    mask = ~past[:, :1, None, :]
    k0, v0 = kc.clone(), vc.clone()
    kc[past], vc[past] = float("nan"), float("nan")
    n_valid = int(lens_np.sum())
    check = f"decode_attention_lse/cp decode B={B} H={H}/{Hkv} S={S}"
    lse_case(rec, flush, check, "decode_attention_lse", DECODE_SRC,
             "leetcuda_tpu/attention/decode.py:223", dec.decode_attention,
             dec.decode_attention_plain, (q, kc, vc, lengths), {},
             4.0 * H * D * n_valid,
             2.0 * (2 * Hkv * n_valid * D + 2 * B * H * D) + 4 * B,
             4.0 * B * H, lambda: sdpa(q[:, :, None], k0, v0,
                                       attn_mask=mask))
    rec.rows[check]["lengths"] = lens_np.tolist()
    del kc, vc, k0, v0
    rec.rows[edges]["check_s"] = time.perf_counter() - t0


# The chunk checks' verify batch: B = 8, T = 4 (k = 3) over a capacity of
# 2048 positions, bases spread from 0 to 2044 (the last chunk ends at 2048).
CHUNK_BASES = np.array([0, 100, 517, 1024, 1200, 1400, 1950, 2044], np.int32)
CHUNK_SRC = "leetcuda_tpu_torch/csrc/chunk_attn.cu"


def check_chunk(rec, flush):
    """The chunk kernel's four entry points at the verify shape (B = 8,
    T = 4: contiguous bf16 / int8 / e4m3, paged bf16 / e4m3, one window
    case) and at admission shapes (B = 1: T = 256 at base 1024 over paged
    e4m3 pools; T = 1024 at base 0 and at base 1024 over a contiguous bf16
    cache). Every position at or past base + T holds NaN values and NaN
    scales (e4m3: the NaN bytes 0x7F / 0xFF); paged, the pages of 128 are
    shuffled, and page 0, every unowned page and the tail of each last page
    hold NaN too. Library yardstick: SDPA with an explicit mask over the
    cache gathered and dequantized beforehand."""
    cases = (  # label, T, bases, format, paged, window
        ("verify", 4, CHUNK_BASES, None, False, None),
        ("verify", 4, CHUNK_BASES, "int8", False, None),
        ("verify", 4, CHUNK_BASES, "fp8", False, None),
        ("verify", 4, CHUNK_BASES, None, True, None),
        ("verify", 4, CHUNK_BASES, "fp8", True, None),
        ("verify window 256", 4, CHUNK_BASES, None, False, 256),
        ("admit T=256 base 1024", 256, np.array([1024], np.int32), "fp8",
         True, None),
        ("admit T=1024 base 0", 1024, np.array([0], np.int32), None, False,
         None),
        ("admit T=1024 base 1024", 1024, np.array([1024], np.int32), None,
         False, None))
    chunk_cases(rec, flush, cases, 16, 4, 2048)


def chunk_cases(rec, flush, cases, H, Hkv, S, D=128, sm_scale=None,
                softcap=None, prefix="", wrong_scale=None):
    """The chunk kernel's cases (label, T, bases, format, paged, window) at
    H / Hkv heads of D over a capacity of S, with ``softcap`` (then q at
    CAP_Q_SCALE, and the cap's controls, with ``wrong_scale`` also the
    scale's); each check's name starts with ``prefix``. See
    ``check_chunk``."""
    from leetcuda_tpu_torch.attention import chunk as ck
    from leetcuda_tpu_torch.core.runtime import as_bytes
    from leetcuda_tpu_torch.models.llama import _quantize_token_kv

    dev, bf = rec.dev, torch.bfloat16
    qdts = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}
    for label, T, bases_np, fmt, paged, window in cases:
        B = len(bases_np)
        base = torch.from_numpy(bases_np).to(dev)
        end_np = np.minimum(bases_np + T, S)
        cols = torch.arange(S, device=dev)
        past = (cols[None, :] >= torch.from_numpy(end_np).to(dev)[:, None])
        past = past[:, None, :].expand(B, Hkv, S)
        q = rec.randn(B, H, T, D, scale=CAP_Q_SCALE if softcap else 1.0)
        kc, vc = rec.randn(B, Hkv, S, D), rec.randn(B, Hkv, S, D)
        if fmt is None:
            kc[past], vc[past] = float("nan"), float("nan")
            tensors, fills = [kc, vc], [float("nan")] * 2
            kd, vd = kc, vc
        else:
            kq, ks = _quantize_token_kv(kc, qdts[fmt])
            vq, vs = _quantize_token_kv(vc, qdts[fmt])
            kd = (kq.float() * ks[..., None]).to(bf)
            vd = (vq.float() * vs[..., None]).to(bf)
            ks[past], vs[past] = float("nan"), float("nan")
            kbyte, vbyte = (0x7F, 0xFF) if fmt == "fp8" else (0, 0)
            as_bytes(kq)[past], as_bytes(vq)[past] = kbyte, vbyte
            tensors = [kq, vq, ks, vs]
            fills = [kbyte, vbyte, float("nan"), float("nan")]
        tbl_bytes = 0.0
        if paged:
            n_pages = -(-end_np // PAGE)
            table, owned = shuffled_table(rec.rng, n_pages, S // PAGE, dev)
            tensors = [to_pool(t, PAGE, table, owned, f)
                       for t, f in zip(tensors, fills)] + [table]
            tbl_bytes = 4.0 * int(n_pages.sum())
        args = (q, *tensors, base)
        kw = {} if window is None else {"window": window}
        if softcap:
            kw.update(softcap=softcap)
        if sm_scale is not None:
            kw.update(sm_scale=sm_scale)
        wrapper, plain = {
            (False, False): (ck.chunk_attention, ck.chunk_attention_plain),
            (True, False): (ck.chunk_attention_quantized,
                            ck.chunk_attention_quantized_plain),
            (False, True): (ck.paged_chunk_attention,
                            ck.paged_chunk_attention_plain),
            (True, True): (ck.paged_chunk_attention_quantized,
                           ck.paged_chunk_attention_quantized_plain),
        }[(fmt is not None, paged)]
        got = wrapper(*args, **kw)
        if not torch.isfinite(got).all():
            raise AssertionError(f"chunk kernel ({label}, {fmt}, paged="
                                 f"{paged}) read a position no row owns")
        # what this case's data needs: the (row, column) pairs each row
        # attends and the positions any row reads
        limit = np.minimum(bases_np[:, None] + np.arange(T)[None, :] + 1, S)
        low = (np.zeros_like(limit) if window is None else np.maximum(
            bases_np[:, None] + np.arange(T)[None, :] + 1 - window, 0))
        pairs = int(np.maximum(limit - low, 0).sum())
        n_pos = int((end_np - low[:, 0]).sum())
        elt = 2 if fmt is None else 1
        nbytes = (2.0 * Hkv * n_pos * D * elt
                  + (8.0 * Hkv * n_pos if fmt else 0.0)
                  + 2 * 2.0 * B * H * T * D + 4 * B + tbl_bytes)
        t_idx = torch.arange(T, device=dev)
        lim_t = base[:, None] + t_idx[None, :] + 1               # (B, T)
        mask = cols[None, None, :] < lim_t[:, :, None]
        if window is not None:
            mask &= cols[None, None, :] >= lim_t[:, :, None] - window
        mask = mask[:, None]                                      # (B,1,T,S)
        kd, vd = torch.nan_to_num(kd), torch.nan_to_num(vd)
        name = wrapper.__name__
        check = (f"{prefix}{name}/{label} {fmt or 'bf16'}"
                 + (f" page{PAGE}" if paged else ""))
        want = plain(*args, **kw)
        rec.record(check, name, CHUNK_SRC,
                   "leetcuda_tpu/attention/chunk.py:"
                   + ("287" if paged else "207"), got, want,
                   time_ms(lambda: wrapper(*args, **kw), flush),
                   time_ms(lambda: plain(*args, **kw), flush, iters=5),
                   time_ms(lambda: sdpa(q, kd, vd, attn_mask=mask,
                                        scale=kw.get("sm_scale")), flush),
                   4.0 * H * D * pairs, nbytes)
        rec.rows[check].update(T=T, mean_base=float(bases_np.mean()),
                               window=window, softcap=softcap)
        if softcap:
            rec.cap_controls(check, lambda c, s=kw.get("sm_scale"): wrapper(
                *args, **{**kw, "softcap": c, "sm_scale": s}), want, softcap,
                wrong_scale)


def check_fused(rec, flush, layer, cfg):
    """The fused norm->QKV->RoPE kernel on ``layer``'s dense ``wqkv`` and
    ``attn_norm`` (B = 8 with positions that differ per row, one of them 0,
    up to 2047; B = 1; and B = 8 with a random norm weight and the (1 + w)
    offset), and the fused norm->matmul kernel on its ``w_gate_up`` and
    ``mlp_norm``. No single PyTorch call computes either: beside each are
    the eager unfused sequence the model would run and the bare
    ``torch.matmul`` on the same (B, D) x (D, X)."""
    from leetcuda_tpu_torch.gemm import fused_decode as fd
    from leetcuda_tpu_torch.models import llama as tl

    dev = rec.dev
    D, X = layer["wqkv"].shape
    heads = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                 head_dim=cfg.head_dim)
    pos8 = torch.tensor([0, 5, 100, 517, 1024, 1500, 2000, 2047],
                        dtype=torch.int32, device=dev)
    rand_nw = rec.randn(D, scale=0.2)
    cases = (("B=8", pos8, layer["attn_norm"], False),
             ("B=1", pos8[-1:], layer["attn_norm"], False),
             ("B=8 random norm weight, offset", pos8, rand_nw, True))
    for label, pos, nw, offset in cases:
        B = pos.shape[0]
        x = rec.randn(B, D)
        kw = dict(eps=cfg.norm_eps, theta=cfg.rope_theta, rms_offset=offset,
                  **heads)
        ocfg = dataclasses.replace(cfg, rms_offset=offset)
        olayer = {"attn_norm": nw, "wqkv": layer["wqkv"]}
        args = (x, nw, layer["wqkv"], pos)
        check = f"fused_norm_qkv_rope/{label} D={D} X={X}"
        rec.record(check, "fused_norm_qkv_rope",
                   "leetcuda_tpu_torch/csrc/fused_decode.cu",
                   "leetcuda_tpu/gemm/fused_decode.py:130",
                   fd.fused_norm_qkv_rope(*args, **kw),
                   fd.fused_norm_qkv_rope_plain(*args, **kw),
                   time_ms(lambda: fd.fused_norm_qkv_rope(*args, **kw),
                           flush),
                   time_ms(lambda: fd.fused_norm_qkv_rope_plain(*args, **kw),
                           flush, iters=5),
                   None, 2.0 * B * D * X,
                   2.0 * (B * D + D + D * X + B * X) + 4 * B)
        rec.rows[check].update(
            eager_unfused_ms=time_ms(lambda: tl._attn_in(
                olayer, x[:, None], pos[:, None], ocfg, 0), flush),
            matmul_ms=time_ms(lambda: torch.matmul(x, layer["wqkv"]), flush))

    w, nw = layer["w_gate_up"], layer["mlp_norm"]
    D, X = w.shape
    x = rec.randn(8, D)
    check = f"fused_norm_matmul/B=8 D={D} X={X}"
    rec.record(check, "fused_norm_matmul",
               "leetcuda_tpu_torch/csrc/fused_decode.cu",
               "leetcuda_tpu/gemm/fused_decode.py:176",
               fd.fused_norm_matmul(x, nw, w, eps=cfg.norm_eps),
               fd.fused_norm_matmul_plain(x, nw, w, eps=cfg.norm_eps),
               time_ms(lambda: fd.fused_norm_matmul(x, nw, w,
                                                    eps=cfg.norm_eps), flush),
               time_ms(lambda: fd.fused_norm_matmul_plain(
                   x, nw, w, eps=cfg.norm_eps), flush, iters=5),
               None, 2.0 * 8 * D * X, 2.0 * (8 * D + D + D * X + 8 * X))
    rec.rows[check].update(
        eager_unfused_ms=time_ms(
            lambda: tl._rms_norm(x, nw, cfg.norm_eps) @ w, flush),
        matmul_ms=time_ms(lambda: torch.matmul(x, w), flush))


def rel_l2(got, want):
    """||got - want|| / ||want|| in f32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def sdpa_backward(q, k, v, do, causal, flush, mask=None):
    """The library yardstick of the backward: ``torch.autograd.grad``
    through ``sdpa`` (dq, dk and dv in one call) after one forward, timed as
    the kernels are; and the name of its longest device kernel, which says
    which backend PyTorch picked. ``mask``: an explicit boolean mask (a
    band) in place of ``causal``."""
    from torch.profiler import ProfilerActivity, profile

    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = (sdpa(qr, kr, vr, is_causal=causal) if mask is None
           else sdpa(qr, kr, vr, attn_mask=mask))

    def run():
        return torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True)

    ms = time_ms(run, flush)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    times = {e.key: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages()}
    return ms, max(times, key=times.get)[:100] if times else "not measured"


FLASH_SRC = "leetcuda_tpu_torch/csrc/flash_fwd.cu"
FLASH_BWD_SRC = "leetcuda_tpu_torch/csrc/flash_bwd.cu"
# (label, (B, H, Hkv, N, D), causal, window, cap, Nk when not N): shapes
# whose tiles cross the end of a head (N = 1000), the group of 1 and of 8,
# and Nq != Nk without a mask
BWD_EDGE_CASES = (
    ("ragged (2, 16, 4, 1000, 128) causal", (2, 16, 4, 1000, 128), True,
     None, None, None),
    ("ragged D=256 window 300, cap 50", (1, 8, 4, 1000, 256), True, 300,
     50.0, None),
    ("group 1", (2, 8, 8, 1024, 128), True, None, None, None),
    ("group 8", (1, 16, 2, 1024, 128), True, None, None, None),
    ("Nq 1000, Nk 1500, non-causal", (1, 8, 2, 1000, 128), False, None,
     None, 1500),
)


# (label, (B, H, Hkv, N, D), causal, window, cap, Nk when not N, ragged,
# with_lse): the TMA forward's edges: tiles that cross the end of a head (N
# = 1000), the group of 1 and of 8, Nq != Nk without a mask, head dim 64,
# and ragged batches whose K and V rows past every length are NaN (the
# output must stay finite: the kernel zeroes those V rows before P V)
FWD_EDGE_CASES = (
    ("N 1000 causal", (2, 16, 4, 1000, 128), True, None, None, None, False,
     True),
    ("group 1", (2, 8, 8, 1024, 128), True, None, None, None, False, False),
    ("group 8", (1, 16, 2, 1024, 128), True, None, None, None, False, True),
    ("Nq 1000, Nk 1500, non-causal", (1, 8, 2, 1000, 128), False, None,
     None, 1500, False, True),
    ("D=64 window 100", (2, 8, 2, 1500, 64), True, 100, None, None, False,
     False),
    ("D=64 non-causal", (2, 8, 2, 1000, 64), False, None, None, None, False,
     True),
    ("ragged NaN past the lengths", (8, 16, 4, 1536, 128), True, None, None,
     None, True, True),
    ("ragged D=256 NaN, window 300, cap 50", (4, 8, 4, 1000, 256), True, 300,
     50.0, None, True, True),
    ("ragged D=64 NaN", (4, 8, 1, 700, 64), True, None, None, None, True,
     False),
)


def check_flash_fwd(rec, flush):
    """The TMA forward's edges (FWD_EDGE_CASES) against
    ``flash_attention_plain`` at KERNEL_TOL, out and lse, a second call bit
    for bit, NaN padding kept out of the output; the lse's control (the lse
    in log2 units must fail) and the cap's (uncapped and at cap / log2(e),
    over q at CAP_Q_SCALE, must fail); each case timed beside its plain
    version and SDPA (causal or not, no cap; a window or lengths as an
    explicit mask); the library's SASS (wgmma and TMA, no mma.sync)."""
    from leetcuda_tpu_torch.attention import flash as fl

    dev = rec.dev
    for (label, (B, H, Hkv, N, D), causal, window, cap, nk, ragged,
         with_lse) in FWD_EDGE_CASES:
        Nk = N if nk is None else nk
        q = rec.randn(B, H, N, D, scale=CAP_Q_SCALE if cap else 1.0)
        k, v = rec.randn(B, Hkv, Nk, D), rec.randn(B, Hkv, Nk, D)
        opt = dict(window=window, softcap=cap)
        lengths = mask = None
        if ragged:
            lens_np = np.linspace(1, N, B).astype(np.int32)
            lengths = torch.from_numpy(lens_np).to(dev)
            kd, vd = k.clone(), v.clone()
            for b, n in enumerate(lens_np):
                k[b, :, n:], v[b, :, n:] = float("nan"), float("nan")
            cols = torch.arange(N, device=dev)
            mask = (fl.band_mask(N, N, dev, True, window)[None]
                    & (cols[None, None, :] < lengths[:, None, None]))[:, None]
            pairs = int(sum(int(fl.band_mask(n, n, "cpu", True, window).sum())
                            for n in lens_np))

            def run(c=cap, with_lse=with_lse):
                return fl.flash_attention_ragged(
                    q, k, v, lengths, window=window, softcap=c,
                    with_lse=with_lse)

            def plain():
                return fl.flash_attention_plain(
                    q, k, v, causal=True, lengths=lengths,
                    with_lse=with_lse, **opt)
            lib = (lambda: sdpa(q, kd, vd, attn_mask=mask))
            name, replaces = ("flash_attention_ragged",
                              "leetcuda_tpu/attention/flash.py:367")
        else:
            pairs = (N * Nk if not causal else
                     int(fl.band_mask(N, Nk, "cpu", True, window).sum()))
            if window:
                mask = fl.band_mask(N, Nk, dev, True, window)

            def run(c=cap, with_lse=with_lse):
                return fl.flash_attention(q, k, v, causal=causal, window=window,
                                          softcap=c, with_lse=with_lse)

            def plain():
                return fl.flash_attention_plain(q, k, v, causal=causal,
                                                with_lse=with_lse, **opt)
            lib = ((lambda: sdpa(q, k, v, attn_mask=mask)) if window
                   else (lambda: sdpa(q, k, v, is_causal=causal)))
            name, replaces = ("flash_attention",
                              "leetcuda_tpu/attention/flash.py:259")
        got, want, again = run(), plain(), run()
        gots = got if with_lse else (got,)
        wants = want if with_lse else (want,)
        if not torch.isfinite(gots[0]).all():
            raise AssertionError(f"flash forward ({label}): a non-finite "
                                 "output (NaN padding got through)")
        if not all(torch.equal(a, b) for a, b in
                   zip(gots, again if with_lse else (again,))):
            raise AssertionError(f"flash forward ({label}): a second call "
                                 "differs")
        out_err = hold(gots[0], wants[0])
        if with_lse:
            name = "flash_attention_lse"
        check = f"{name}/edge: {label}"
        q_bytes, kv_bytes = 2.0 * B * H * N * D, 2.0 * B * Hkv * Nk * D
        rec.record(check, name, FLASH_SRC, replaces, gots[-1], wants[-1],
                   time_ms(run, flush), time_ms(plain, flush, iters=5),
                   time_ms(lib, flush), 4.0 * (B if not ragged else 1)
                   * H * D * pairs, 2 * q_bytes + 2 * kv_bytes
                   + (4.0 * B * H * N if with_lse else 0.0))
        rec.rows[check].update(out_max_abs_err=out_err, repeat_bit_equal=True,
                               shape=[B, H, Hkv, N, Nk, D], window=window,
                               softcap=cap, plan=fl.fwd_plan(D, B, H, N),
                               library="SDPA" + (", explicit mask" if mask
                                                 is not None else "")
                               + (", no softcap" if cap else ""))
        if with_lse and not ragged and not cap:
            lse_controls(rec, check, wants[-1], lambda w: run()[1], None)
        if cap:
            rec.cap_controls(check, lambda c: run(c)[-1] if with_lse
                             else run(c), wants[-1], cap)
        del q, k, v, got, want, again, mask
    rec.rows["flash_attention"]["sass"] = resident_sass("flash_fwd")


def band_pairs(n, window):
    """(row, key) pairs the causal band of n rows keeps."""
    if not window or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def check_flash_bwd(rec, flush):
    """The forward's lse (causal at training's shape (8, 16, 2048, 128)
    with 4 KV heads, and the ragged batch of the ragged check: rows past a
    length -1e30), then the dQ and dK/dV kernels against
    ``flash_attention_bwd_plain`` at training's shape: causal, non-causal,
    head dim 64, with a random lse cotangent, and with Gemma 2's options:
    a window of 512 (on a 64-key tile edge) with the cap of 50, the cap
    alone, the same two at BWD_CAP, a window of 1000 (inside a tile);
    ``out`` and ``lse`` from the kernel forward, held against the plain
    forward's first, and a random ``do``; then BWD_EDGE_CASES. Each
    backward case holds dq, dk and dv by relative L2 error (BWD_REL_L2) and
    elementwise (KERNEL_TOL), a second call bit for bit and the dQ launch's
    delta against ``_delta``; at BWD_CAP the backward uncapped and at cap /
    log2(e) must fail BWD_REL_L2 (see CAP_Q_SCALE), and without the lse
    cotangent the "dlse" case. The plain time is
    the whole plain backward and the library time SDPA's (both give all
    three gradients; with a window SDPA takes the band as an explicit mask,
    and it has no softcap)."""
    from leetcuda_tpu_torch.attention import flash as fl
    from leetcuda_tpu_torch.attention import flash_bwd as fb

    dev, H, Hkv = rec.dev, 16, 4
    B, N, D = TRAIN_B, TRAIN_S, 128
    q, k, v = rec.randn(B, H, N, D), rec.randn(B, Hkv, N, D), rec.randn(
        B, Hkv, N, D)
    out, lse = fl.flash_attention(q, k, v, causal=True, with_lse=True)
    w_out, w_lse = fl.flash_attention_plain(q, k, v, causal=True,
                                            with_lse=True)
    torch.testing.assert_close(out.float(), w_out.float(), **KERNEL_TOL)
    pairs = N * (N + 1) // 2
    check = "flash_attention_lse/causal"
    rec.record(check, "flash_attention_lse", FLASH_SRC,
               "leetcuda_tpu/attention/flash.py:259", lse, w_lse,
               time_ms(lambda: fl.flash_attention(q, k, v, causal=True,
                                                  with_lse=True), flush),
               time_ms(lambda: fl.flash_attention_plain(
                   q, k, v, causal=True, with_lse=True), flush, iters=5),
               time_ms(lambda: sdpa(q, k, v, is_causal=True), flush),
               4.0 * B * H * D * pairs,
               2.0 * (2 * B * H * N * D + 2 * B * Hkv * N * D)
               + 4.0 * B * H * N)
    rec.rows[check]["out_max_abs_err"] = float(
        (out.float() - w_out.float()).abs().max())

    B, N = 8, 1536
    lens_np = np.linspace(1, N, B).astype(np.int32)
    lengths = torch.from_numpy(lens_np).to(dev)
    q, k, v = rec.randn(B, H, N, D), rec.randn(B, Hkv, N, D), rec.randn(
        B, Hkv, N, D)
    out, lse = fl.flash_attention_ragged(q, k, v, lengths, with_lse=True)
    w_out, w_lse = fl.flash_attention_plain(q, k, v, causal=True,
                                            lengths=lengths, with_lse=True)
    torch.testing.assert_close(out.float(), w_out.float(), **KERNEL_TOL)
    dead = torch.arange(N, device=dev)[None, None, :] >= lengths[:, None,
                                                                None]
    if not bool((lse[dead.expand_as(lse)] == -1e30).all()):
        raise AssertionError("ragged lse: rows past a length are not -1e30")
    cols = torch.arange(N, device=dev)
    mask = ((cols[None, :] <= cols[:, None])[None]
            & (cols[None, None, :] < lengths[:, None, None]))[:, None]
    n_valid = int(lens_np.sum())
    check = "flash_attention_lse/ragged"
    rec.record(check, "flash_attention_lse", FLASH_SRC,
               "leetcuda_tpu/attention/flash.py:367", lse, w_lse,
               time_ms(lambda: fl.flash_attention_ragged(
                   q, k, v, lengths, with_lse=True), flush),
               time_ms(lambda: fl.flash_attention_plain(
                   q, k, v, causal=True, lengths=lengths, with_lse=True),
                   flush, iters=5),
               time_ms(lambda: sdpa(q, k, v, attn_mask=mask), flush),
               4.0 * H * D * int(sum(n * (n + 1) // 2 for n in lens_np)),
               2.0 * (H * n_valid * D + 2 * Hkv * n_valid * D + B * H * N * D)
               + 4.0 * B * H * N)
    rec.rows[check]["out_max_abs_err"] = float(
        (out.float() - w_out.float()).abs().max())

    for label, D, causal, with_dlse, window, cap in (
            ("causal", 128, True, False, None, None),
            ("non-causal", 128, False, False, None, None),
            ("causal D=64", 64, True, False, None, None),
            ("causal, dlse", 128, True, True, None, None),
            ("window 512, cap 50", 128, True, False, 512, 50.0),
            ("cap 50", 128, True, False, None, 50.0),
            ("window 512, cap 2", 128, True, False, 512, BWD_CAP),
            ("cap 2", 128, True, False, None, BWD_CAP),
            ("window 1000", 128, True, False, 1000, None)):
        bwd_case(rec, flush, label, (TRAIN_B, H, Hkv, TRAIN_S, D), causal,
                 with_dlse, window, cap)
    # the TMA kernels' edges (BWD_EDGE_CASES): tiles that run past N (zero
    # rows, never the next head's), groups of 1 and 8, Nq != Nk
    for label, shape, causal, window, cap, nk in BWD_EDGE_CASES:
        bwd_case(rec, flush, label, shape, causal, window=window, cap=cap,
                 nk=nk)
    # both kernels on wgmma fed by TMA; no mma.sync route left
    rec.rows["flash_attention_bwd_dq/causal"]["sass"] = resident_sass(
        "flash_bwd")


def bwd_case(rec, flush, label, shape, causal, with_dlse=False, window=None,
             cap=None, prefix="", wrong_scale=None, nk=None):
    """One backward check at ``shape`` (B, H, Hkv, N, D), the default scale
    1 / sqrt(D): ``out`` and ``lse`` from the kernel forward, held against
    the plain forward's first (with ``nk`` keys, Nq != Nk: from the plain
    forward), a random ``do`` (and ``dlse``); dq, dk and dv by relative L2
    error (BWD_REL_L2) and elementwise (KERNEL_TOL); a second call bit for
    bit; the delta that the dQ launch writes against ``_delta`` (relative
    L2 at most 1e-5). At BWD_CAP the backward uncapped and at cap / log2(e)
    must fail BWD_REL_L2, with ``wrong_scale`` so must the backward at that
    scale, and with ``dlse`` so must the backward without it. The plain
    time is the whole plain backward, the library time SDPA's (all three
    gradients; a window as an explicit band mask; no softcap). Each check's
    name starts with ``prefix``."""
    from leetcuda_tpu_torch.attention import flash as fl
    from leetcuda_tpu_torch.attention import flash_bwd as fb

    dev = rec.dev
    B, H, Hkv, N, D = shape
    Nk = N if nk is None else nk
    scale = 1.0 / np.sqrt(D)
    opt = dict(window=window, softcap=cap)
    q, k, v = rec.randn(B, H, N, D), rec.randn(B, Hkv, Nk, D), rec.randn(
        B, Hkv, Nk, D)
    w_out, w_lse = fl.flash_attention_plain(q, k, v, causal=causal,
                                            with_lse=True, **opt)
    if nk is None:
        out, lse = fl.flash_attention(q, k, v, causal=causal, with_lse=True,
                                      **opt)
        torch.testing.assert_close(out.float(), w_out.float(), **KERNEL_TOL)
        torch.testing.assert_close(lse, w_lse, **KERNEL_TOL)
    else:
        out, lse = w_out.to(q.dtype).contiguous(), w_lse
    del w_out, w_lse
    do = rec.randn(B, H, N, D)
    dlse = rec.randn(B, H, N).float() if with_dlse else None
    got = fb.flash_attention_bwd(q, k, v, out, lse, do, dlse,
                                 causal=causal, **opt)
    want = fb.flash_attention_bwd_plain(q, k, v, out, lse, do, dlse,
                                        causal=causal, sm_scale=scale,
                                        **opt)
    errs = {f"d{n}": rel_l2(g, w) for n, g, w in zip("qkv", got, want)}
    if max(errs.values()) > BWD_REL_L2:
        raise AssertionError(f"flash backward ({label}): relative L2 "
                             f"errors {errs} over {BWD_REL_L2}")
    again = fb.flash_attention_bwd(q, k, v, out, lse, do, dlse,
                                   causal=causal, **opt)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"flash backward ({label}): a second call "
                             "differs")
    del again
    _, rows = fb._launch_dq(q, k, v, out, do, lse, dlse, causal, scale,
                            window or 0, cap or 0.0)
    delta_err = rel_l2(fb.rows_delta(rows, N), fb._delta(out, do, dlse))
    if not delta_err <= 1e-5:
        raise AssertionError(f"flash backward ({label}): the dQ launch's "
                             f"delta is {delta_err} from _delta")
    controls = {}  # a wrong cap, scale or lse cotangent must fail the check
    runs = ((("uncapped", None, scale, dlse),
             ("log2 domain", cap / LOG2E, scale, dlse))
            if cap == BWD_CAP else ())
    if wrong_scale is not None:
        runs += ((f"scale {wrong_scale:.4g}", cap, wrong_scale, dlse),)
    if with_dlse:
        runs += (("dlse dropped", cap, scale, None),)
    for c_label, c, c_scale, c_dlse in runs:
        c_got = fb.flash_attention_bwd(q, k, v, out, lse, do, c_dlse,
                                       causal=causal, window=window,
                                       softcap=c, sm_scale=c_scale)
        controls[c_label] = {f"d{n}": rel_l2(g, w) for n, g, w in
                             zip("qkv", c_got, want)}
        if all(e <= BWD_REL_L2 for e in controls[c_label].values()):
            raise AssertionError(f"flash backward ({label}): the kernel "
                                 f"{c_label} passes the check")
        del c_got
    plain_ms = time_ms(lambda: fb.flash_attention_bwd_plain(
        q, k, v, out, lse, do, dlse, causal=causal, sm_scale=scale,
        **opt), flush, iters=5)
    lib_ms, lib_kernel = sdpa_backward(
        q, k, v, do, causal, flush,
        None if window is None else fl.band_mask(N, Nk, dev, True, window))
    whole_ms = time_ms(lambda: fb.flash_attention_bwd(
        q, k, v, out, lse, do, dlse, causal=causal, **opt), flush)
    dq_ms = time_ms(lambda: fb._launch_dq(q, k, v, out, do, lse, dlse,
                                          causal, scale, window or 0,
                                          cap or 0.0), flush)
    dkv_ms = time_ms(lambda: fb._launch_dkv(q, k, v, do, rows, causal,
                                            scale, window or 0, cap or 0.0),
                     flush)
    pairs = (N * Nk if not causal else band_pairs(N, window) if Nk == N
             else int(fl.band_mask(N, Nk, "cpu", True, window).sum()))
    product = 2.0 * B * H * D * pairs  # FLOPs of one N x Nk x D product
    q_bytes, kv_bytes = 2.0 * B * H * N * D, 2.0 * B * Hkv * Nk * D
    # lse and delta (and dlse), f32
    row_bytes = (12.0 if with_dlse else 8.0) * B * H * N
    bound_ms = 5 * product / BF16_FLOP_PER_S * 1e3
    extra = dict(rel_l2=errs, library_kernel=lib_kernel,
                 cap_controls_rel_l2=controls or None,
                 delta_rel_l2=delta_err, repeat_bit_equal=True,
                 backward_ms=whole_ms, shape=list(shape) + [Nk],
                 backward_bound_ms=bound_ms,
                 backward_share=bound_ms / whole_ms,
                 backward_tflops=5 * product / whole_ms / 1e9,
                 backward_over_sdpa=whole_ms / lib_ms,
                 plan=fb.bwd_plan(D, B, H, Hkv, N, Nk))
    check = f"{prefix}flash_attention_bwd_dq/{label}"
    rec.record(check, "flash_attention_bwd_dq", FLASH_BWD_SRC,
               "leetcuda_tpu/attention/flash_bwd.py:196", got[0], want[0],
               dq_ms, plain_ms, lib_ms, 3 * product,
               4 * q_bytes + 2 * kv_bytes + row_bytes)
    rec.rows[check].update(extra)
    rec.rows[check]["share"] = rec.rows[check]["bound_ms"] / dq_ms
    check = f"{prefix}flash_attention_bwd_dkv/{label}"
    rec.record(check, "flash_attention_bwd_dkv", FLASH_BWD_SRC,
               "leetcuda_tpu/attention/flash_bwd.py:215",
               torch.cat([got[1].flatten(), got[2].flatten()]),
               torch.cat([want[1].flatten(), want[2].flatten()]),
               dkv_ms, plain_ms, lib_ms, 4 * product,
               2 * q_bytes + 4 * kv_bytes + row_bytes)
    rec.rows[check].update(extra)
    rec.rows[check]["share"] = rec.rows[check]["bound_ms"] / dkv_ms


def check_kernels(flush, mm_cases, fused_layer, cfg, dev="cuda"):
    """Phase 3: each kernel against its plain version at main-path shapes
    (``mm_cases``: see matmul_cases; ``fused_layer``: layer 0 of the dense
    fused params). Returns one row per check; the first check of a kernel
    is its row in the kernels line."""
    from leetcuda_tpu_torch.attention import decode as dec
    from leetcuda_tpu_torch.attention import flash as fl
    from leetcuda_tpu_torch.gemm import quant as gq
    from leetcuda_tpu_torch.models.llama import _quantize_token_kv, as_bytes

    rec = Recorder(dev)
    rows, randn, record = rec.rows, rec.randn, rec.record
    bf = torch.bfloat16

    # flash causal, (1, 16, 2048, 128), Hkv = 4
    B, H, Hkv, N, D = 1, 16, 4, 2048, 128
    q, k, v = randn(B, H, N, D), randn(B, Hkv, N, D), randn(B, Hkv, N, D)
    got = fl.flash_attention(q, k, v, causal=True)
    want = fl.flash_attention_plain(q, k, v, causal=True)
    pairs = N * (N + 1) // 2  # (row, key) pairs the causal mask keeps
    record("flash_attention", "flash_attention",
           "leetcuda_tpu_torch/csrc/flash_fwd.cu",
           "leetcuda_tpu/attention/flash.py:259", got, want,
           time_ms(lambda: fl.flash_attention(q, k, v, causal=True), flush),
           time_ms(lambda: fl.flash_attention_plain(q, k, v, causal=True),
                   flush, iters=5),
           time_ms(lambda: sdpa(q, k, v, is_causal=True), flush),
           4.0 * B * H * D * pairs,
           2.0 * (2 * B * H * N * D + 2 * B * Hkv * N * D))

    # ragged flash, B = 8, N = 1536, lengths spread over 1..1536
    B, N = 8, 1536
    lens_np = np.linspace(1, N, B).astype(np.int32)
    lengths = torch.from_numpy(lens_np).to(dev)
    q, k, v = randn(B, H, N, D), randn(B, Hkv, N, D), randn(B, Hkv, N, D)
    got = fl.flash_attention_ragged(q, k, v, lengths)
    want = fl.flash_attention_plain(q, k, v, causal=True, lengths=lengths)
    cols = torch.arange(N, device=dev)
    mask = ((cols[None, :] <= cols[:, None])[None]
            & (cols[None, None, :] < lengths[:, None, None]))[:, None]
    n_valid = int(lens_np.sum())
    pairs = int(sum(n * (n + 1) // 2 for n in lens_np))
    record("flash_attention_ragged", "flash_attention_ragged",
           "leetcuda_tpu_torch/csrc/flash_fwd.cu",
           "leetcuda_tpu/attention/flash.py:367", got, want,
           time_ms(lambda: fl.flash_attention_ragged(q, k, v, lengths),
                   flush),
           time_ms(lambda: fl.flash_attention_plain(
               q, k, v, causal=True, lengths=lengths), flush, iters=5),
           time_ms(lambda: sdpa(q, k, v, attn_mask=mask), flush),
           4.0 * H * D * pairs,
           2.0 * (H * n_valid * D + 2 * Hkv * n_valid * D + B * H * N * D))

    # decode, B = 8, H = 16, Hkv = 4, S_max = 2048, NaN past every length
    B, S = 8, 2048
    lens_np = DECODE_LENS
    lengths = torch.from_numpy(lens_np).to(dev)
    q, kc, vc = randn(B, H, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    for b, n in enumerate(lens_np):
        kc[b, :, n:] = float("nan")
        vc[b, :, n:] = float("nan")
    got = dec.decode_attention(q, kc, vc, lengths)
    if not torch.isfinite(got).all():
        raise AssertionError("decode kernel let NaN padding through")
    want = dec.decode_attention_plain(q, kc, vc, lengths)
    dmask = (torch.arange(S, device=dev)[None, :]
             < lengths[:, None])[:, None, None, :]
    n_valid = int(lens_np.sum())
    record("decode_attention", "decode_attention",
           DECODE_SRC,
           "leetcuda_tpu/attention/decode.py:223", got, want,
           time_ms(lambda: dec.decode_attention(q, kc, vc, lengths), flush),
           time_ms(lambda: dec.decode_attention_plain(q, kc, vc, lengths),
                   flush, iters=5),
           time_ms(lambda: sdpa(q[:, :, None], kc, vc, attn_mask=dmask),
                   flush),
           4.0 * H * D * n_valid,
           2.0 * (2 * Hkv * n_valid * D + 2 * B * H * D) + 4 * B)

    # decode attention over a quantized cache: the same shapes and lengths,
    # NaN scales past every length and, for e4m3, NaN bytes (0x7F / 0xFF).
    # Library yardstick: SDPA over the cache dequantized to bf16 beforehand.
    for fmt, qdt in (("fp8", torch.float8_e4m3fn), ("int8", torch.int8)):
        kq, ks = _quantize_token_kv(randn(B, Hkv, S, D), qdt)
        vq, vs = _quantize_token_kv(randn(B, Hkv, S, D), qdt)
        for b, n in enumerate(lens_np):
            ks[b, :, n:] = float("nan")
            vs[b, :, n:] = float("nan")
            if fmt == "fp8":
                as_bytes(kq)[b, :, n:] = 0x7F
                as_bytes(vq)[b, :, n:] = 0xFF
        args = (q, kq, vq, ks, vs, lengths)
        got = dec.decode_attention_quantized(*args)
        if not torch.isfinite(got).all():
            raise AssertionError("quantized decode let NaN padding through")
        want = dec.decode_attention_quantized_plain(*args)
        kd = (kq.float() * ks[..., None]).to(bf)
        vd = (vq.float() * vs[..., None]).to(bf)
        record(f"decode_attention_quantized/{fmt}",
               "decode_attention_quantized",
               DECODE_SRC,
               "leetcuda_tpu/attention/decode.py:308", got, want,
               time_ms(lambda: dec.decode_attention_quantized(*args), flush),
               time_ms(lambda: dec.decode_attention_quantized_plain(*args),
                       flush, iters=5),
               time_ms(lambda: sdpa(q[:, :, None], kd, vd, attn_mask=dmask),
                       flush),
               4.0 * H * D * n_valid,
               2 * Hkv * n_valid * D + 8.0 * Hkv * n_valid
               + 4.0 * B * H * D + 4 * B)

    # the quantized matmuls at every weight shape and row count of the main
    # paths, each in the wrapper's route and in both routes (the A/B that
    # sets gq.W8_DECODE_MAX_ROWS and gq.W4_DECODE_MAX_ROWS), each route
    # twice bit for bit. Library yardstick: torch.matmul on the weight
    # dequantized to bf16 beforehand, which reads twice (w8a16) or four
    # times (w4a16) the weight bytes.
    for path, key, w, m_rows in mm_cases:
        if "q4" in w:
            name, args = "matmul_w4a16", (w["q4"], w["s4"])
            wrapper, plain, launch = (gq.matmul_w4a16, gq.matmul_w4a16_plain,
                                      gq._launch_w4a16)
            (Kh, N), fmt = args[0].shape, "int4"
            K = 2 * Kh
            w_bytes = K * N / 2 + 4.0 * (K // 128) * N
            wd = gq.dequantize_int4(*args).to(bf)
            src, replaces = "w4_matmul.cu", "leetcuda_tpu/gemm/quant.py:371"
        else:
            name, args = "matmul_w8a16", (w["q"], w["s"])
            wrapper, plain, launch = (gq.matmul_w8a16, gq.matmul_w8a16_plain,
                                      gq._launch_w8a16)
            (K, N) = args[0].shape
            fmt = "fp8" if args[0].dtype == torch.float8_e4m3fn else "int8"
            w_bytes = K * N + 4.0 * N
            wd = (args[0].float() * args[1]).to(bf)
            src, replaces = "wq_matmul.cu", "leetcuda_tpu/gemm/quant.py:108"
        for M in m_rows:
            x = randn(M, K)
            want = plain(x, *args)
            tiles = {}
            for tile in ("decode", "prefill"):
                got = launch(x, *args, tile == "decode")
                torch.testing.assert_close(got.float(), want.float(),
                                           **KERNEL_TOL)
                if not torch.equal(got, launch(x, *args, tile == "decode")):
                    raise AssertionError(f"{name} {tile} route M={M} K={K} "
                                         f"N={N}: a second call differs")
                tiles[tile] = (
                    time_ms(lambda: launch(x, *args, tile == "decode"),
                            flush),
                    float((got.float() - want.float()).abs().max()))
            check = f"{name}/({path}) {key} {fmt} M={M} K={K} N={N}"
            record(check, name, f"leetcuda_tpu_torch/csrc/{src}", replaces,
                   wrapper(x, *args), want,
                   time_ms(lambda: wrapper(x, *args), flush),
                   time_ms(lambda: plain(x, *args), flush, iters=5),
                   time_ms(lambda: torch.matmul(x, wd), flush),
                   2.0 * M * N * K, 2.0 * M * K + w_bytes + 2.0 * M * N)
            rows[check].update(
                M=M, K=K, N=N, path=path,
                ms_decode_tile=tiles["decode"][0],
                ms_prefill_tile=tiles["prefill"][0],
                max_abs_err_tiles=max(e for _, e in tiles.values()))
            plan = gq.w4_plan if name == "matmul_w4a16" else gq.w8_plan
            rows[check].update(repeat_bit_equal=True, route_plan={
                r: plan(M, N, K, r == "decode")["grid"]
                for r in ("decode", "prefill")})
    for name, lib in (("matmul_w4a16", "w4_matmul"),
                      ("matmul_w8a16", "wq_matmul")):
        named = [r for r in rows.values() if r["name"] == name]
        if named:  # wgmma fed by TMA on both routes, no mma.sync
            named[0]["sass"] = resident_sass(lib)

    # e4m3 NaN bytes decode to NaN on both routes as in the plain version, at
    # a decode step's rows and at a prefill's
    w = next(w for _, _, w, _ in mm_cases
             if w.get("q") is not None and w["q"].dtype == torch.float8_e4m3fn)
    wq, ws = w["q"].clone(), w["s"]
    as_bytes(wq)[0, :8] = torch.tensor([0x7F, 0xFF] * 4, dtype=torch.uint8,
                                       device=dev)
    for M in (8, 384):
        x = randn(M, wq.shape[0])
        nan_p = torch.isnan(gq.matmul_w8a16_plain(x, wq, ws))
        for decode in (True, False):
            nan_k = torch.isnan(gq._launch_w8a16(x, wq, ws, decode))
            if not (nan_k[:, :8].all() and torch.equal(nan_k, nan_p)):
                raise AssertionError("e4m3 bytes 0x7F / 0xFF do not decode "
                                     f"to NaN (M={M}, decode={decode})")
    nan_c = torch.isnan(gq._launch_w8_to_bf16(as_bytes(wq), True).float())
    if not torch.equal(nan_c, torch.isnan(wq.float())):
        raise AssertionError("w8_to_bf16: e4m3 bytes 0x7F / 0xFF do not "
                             "decode to NaN")

    # the prefill route's first pass alone, at the widest pack of each
    # format (w_gate_up), exact and against its byte bound (the bytes read,
    # twice as many written): its share of a prefill's w8a16 time
    for qdt in (torch.float8_e4m3fn, torch.int8):
        q = max((w["q"] for _, _, w, _ in mm_cases
                 if w.get("q") is not None and w["q"].dtype == qdt),
                key=lambda t: t.numel())
        (K, N), fp8 = q.shape, qdt == torch.float8_e4m3fn
        qb = as_bytes(q)
        got, want = gq._launch_w8_to_bf16(qb, fp8), q.float().to(bf)
        if not (torch.equal(got, want)
                and torch.equal(got, gq._launch_w8_to_bf16(qb, fp8))):
            raise AssertionError(f"w8_to_bf16 K={K} N={N}: not the exact "
                                 f"values, or a second call differs")
        check = f"w8_to_bf16/{'fp8' if fp8 else 'int8'} K={K} N={N}"
        record(check, "w8_to_bf16", "leetcuda_tpu_torch/csrc/wq_matmul.cu",
               "leetcuda_tpu/gemm/quant.py:108", got, want,
               time_ms(lambda: gq._launch_w8_to_bf16(qb, fp8), flush),
               time_ms(lambda: q.float().to(bf), flush, iters=5),
               time_ms(lambda: q.to(bf), flush), 0.0, 3.0 * K * N)
        rows[check].update(K=K, N=N, exact=True)

    check_decode_split(rec, flush)
    check_paged(rec, flush)
    check_fused(rec, flush, fused_layer, cfg)
    check_chunk(rec, flush)
    check_flash_bwd(rec, flush)  # first: its rows lead the kernels line
    check_flash_fwd(rec, flush)
    return rows


class StepGraphs:
    """B=1 ``decode_step`` of one params set over one cache type (contiguous,
    ``kv_quant``), captured as a CUDA graph per cache length and replayed
    token by token: the same kernels on the same inputs in the same order as
    the eager step, without the host's ~1000 launches a step, which made the
    solo replays of phase 5 host-bound. The first stream replayed through
    an instance is also replayed eagerly (``held``) and must give the same
    gaps bit for bit."""

    def __init__(self, params, cfg, kv_quant=None):
        self.params, self.cfg, self.kvq = params, cfg, kv_quant
        self.dev = params["embed"].device
        self.stream = torch.cuda.Stream(self.dev)
        self.graphs = {}
        self.held = False

    def caches(self, n):
        """The length-``n`` graph's caches, reset to what init_kv_caches
        makes (zeros, scales of one)."""
        from leetcuda_tpu_torch.core.runtime import as_bytes
        from leetcuda_tpu_torch.models.llama import init_kv_caches

        caches = self._graph(n)["caches"]
        fresh = init_kv_caches(self.cfg, 1, n, quant=self.kvq,
                               device=self.dev)
        for c, f in zip(caches, fresh):
            for k, v in c.items():
                as_bytes(v).copy_(as_bytes(f[k]))
        return caches

    def step(self, n, tok, pos):
        """One decode step of ``tok`` ((1,) int32) at position ``pos`` over
        the length-``n`` caches; the (1, V) logits, overwritten by the next
        step of that length."""
        g = self._graph(n)
        g["tok"].copy_(tok)
        g["lengths"].fill_(pos)
        g["graph"].replay()
        return g["logits"]

    def _graph(self, n):
        from leetcuda_tpu_torch.models.llama import decode_step, init_kv_caches

        g = self.graphs.get(n)
        if g is None:
            caches = init_kv_caches(self.cfg, 1, n, quant=self.kvq,
                                    device=self.dev)
            tok = torch.zeros(1, dtype=torch.int32, device=self.dev)
            lengths = torch.zeros(1, dtype=torch.int32, device=self.dev)
            cur = torch.cuda.current_stream(self.dev)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):  # the kernels' split
                decode_step(self.params, tok, caches, lengths,  # scratch,
                            self.cfg)  # made outside the capture
            cur.wait_stream(self.stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.stream):
                logits, _ = decode_step(self.params, tok, caches, lengths,
                                        self.cfg)
            g = self.graphs[n] = {"graph": graph, "caches": caches,
                                  "tok": tok, "lengths": lengths,
                                  "logits": logits}
        return g


GRAPH_SCRATCH_LEN, GRAPH_SCRATCH_STEPS = 1024, 8


def graph_scratch_check(params, cfg, kv_quant, n=GRAPH_SCRATCH_LEN,
                        steps=GRAPH_SCRATCH_STEPS):
    """The card check of the per-stream scratch buffers (gemm/quant.py
    ``_split_scratch``, attention/decode.py ``_stream_counters``): a B=1
    ``decode_step`` of ``params`` over a ``kv_quant`` cache of ``n``
    positions is captured as a CUDA graph (StepGraphs), so that the w8a16
    split-K route and the split-KV decode kernel both launch from the graph
    into that stream's buffers. Then eager calls on the same stream grow
    both: a B=8 decode_step (the split-K workspace) and a decode attention
    of more rows than the stream's counter buffer holds. The superseded
    buffers must still be allocated, held by the package at the addresses
    the graph launches into; and the graph, replayed for ``steps`` tokens
    from position n / 2 (every decode row over two or more splits, so the
    counters count), must give an eager B=1 decode_step's logits bit for
    bit. Returns the buffers' sizes before and after and the steps
    compared."""
    from leetcuda_tpu_torch.attention import decode as da
    from leetcuda_tpu_torch.gemm import quant as gq
    from leetcuda_tpu_torch.models.llama import decode_step, init_kv_caches

    graphs = StepGraphs(params, cfg, kv_quant)
    dev = graphs.dev
    key = (dev.index, graphs.stream.cuda_stream)
    graphs.caches(n)  # warms the stream, then captures

    def buffers():
        return [(t.data_ptr(), t.numel() * t.element_size()) for t in (
            *gq._SPLIT_SCRATCH[key], da._STREAM_COUNTERS[key])]

    before = buffers()
    gen = torch.Generator(device=dev).manual_seed(21)
    with torch.cuda.stream(graphs.stream):
        caches = init_kv_caches(cfg, 8, n, quant=kv_quant, device=dev)
        decode_step(params, torch.randint(
            0, cfg.vocab_size, (8,), generator=gen, device=dev,
            dtype=torch.int32), caches,
            torch.full((8,), n // 2, dtype=torch.int32, device=dev), cfg)
        del caches
        D, Hkv = cfg.head_dim, cfg.n_kv_heads
        S = 2 * da.SPLIT_KEYS[D]
        B = (da._STREAM_COUNTERS[key].numel()
             // (Hkv * da.split_plan(1, cfg.n_heads, Hkv, D, S).head_blocks)
             + 1)
        k = torch.zeros((B, Hkv, S, D), dtype=torch.bfloat16, device=dev)
        da.decode_attention(
            torch.zeros((B, cfg.n_heads, D), dtype=torch.bfloat16,
                        device=dev), k, k,
            torch.full((B,), S, dtype=torch.int32, device=dev))
        del k
    graphs.stream.synchronize()
    after = buffers()
    if after[0][1] <= before[0][1] or after[2][1] <= before[2][1]:
        raise AssertionError(f"graph scratch: the eager calls grew nothing "
                             f"({before} -> {after})")
    held = {t.data_ptr() for t in gq._SPLIT_RETIRED + da._RETIRED_COUNTERS}
    held |= {p for p, _ in after}  # a buffer that did not grow stays live
    lost = [p for p, _ in before if p not in held]
    if lost:
        raise AssertionError(f"graph scratch: growth let go of buffers the "
                             f"graph launches into (at {lost})")
    toks = torch.randint(0, cfg.vocab_size, (steps,), generator=gen,
                         device=dev, dtype=torch.int32)
    graphs.caches(n)
    got = torch.stack([graphs.step(n, toks[t:t + 1], n // 2 + t)[0].clone()
                       for t in range(steps)])
    caches = init_kv_caches(cfg, 1, n, quant=kv_quant, device=dev)
    lengths = torch.full((1,), n // 2, dtype=torch.int32, device=dev)
    want = []
    for t in range(steps):
        logits, caches = decode_step(params, toks[t:t + 1], caches, lengths,
                                     cfg)
        want.append(logits[0])
        lengths += 1
    want = torch.stack(want)
    if not torch.equal(got, want):
        raise AssertionError(
            f"graph scratch: after the stream's buffers grew, the graphed "
            f"B=1 step differs from the eager one (max abs "
            f"{float((got.float() - want.float()).abs().max()):.3g})")
    return {"bytes_before": [b for _, b in before],
            "bytes_after": [b for _, b in after], "steps": steps,
            "from_position": n // 2, "bit_equal": True}


def held_gap(graphs, gaps):
    """The largest of ``gaps(graphs)`` (per-token gaps of one stream); the
    first stream of a StepGraphs is also replayed eagerly (``gaps(None)``),
    which must give the same gaps bit for bit."""
    got = gaps(graphs)
    if graphs is not None and not graphs.held:
        want = gaps(None)
        if not torch.equal(got, want):
            raise AssertionError(f"a graphed replay differs from the eager "
                                 f"one: {got.tolist()} vs {want.tolist()}")
        graphs.held = True
    return float(got.max())


def teacher_forced_gap(params, cfg, prompt, tokens, graphs=None):
    """Largest (max logit - logit of the served token) over a solo B=1
    decode_step replay of prompt + tokens, on the params' device (through
    ``graphs``, a StepGraphs of these params without KV quantization, where
    given)."""
    from leetcuda_tpu_torch.models.llama import decode_step, init_kv_caches

    dev = params["embed"].device
    seq = list(prompt) + list(tokens)
    n = len(seq) + (-len(seq) % 128)
    toks = torch.tensor(seq, dtype=torch.int32, device=dev)
    tgt = torch.tensor(list(tokens), dtype=torch.long, device=dev)

    def gaps(graphs):
        if graphs is not None:
            graphs.caches(n)
        else:
            caches = init_kv_caches(cfg, 1, n, device=dev)
            lengths = torch.zeros(1, dtype=torch.int32, device=dev)
        out = []
        for t in range(len(seq) - 1):
            if graphs is not None:
                logits = graphs.step(n, toks[t:t + 1], t)
            else:
                logits, caches = decode_step(params, toks[t:t + 1], caches,
                                             lengths, cfg)
                lengths += 1
            j = t - (len(prompt) - 1)
            if j >= 0:
                out.append(logits[0].max() - logits[0, tgt[j]])
        return torch.stack(out)

    return held_gap(graphs, gaps)


def replay_gap(params, cfg, prompt, tokens, kv_quant, graphs=None):
    """The same gap over a solo replay of a quantized path: one B=1
    ``forward`` over the prompt, its K/V inserted into a B=1 cache of the
    path's type, then one B=1 decode_step per served token (through
    ``graphs``, a StepGraphs of these params and cache type, where given)."""
    from leetcuda_tpu_torch.engine.engine import _insert_kvs
    from leetcuda_tpu_torch.models.llama import (decode_step, forward,
                                                 init_kv_caches)

    dev = params["embed"].device
    L, n = len(prompt), len(tokens)
    size = L + n + (-(L + n) % 128)
    toks = torch.tensor(list(tokens), dtype=torch.int32, device=dev)

    def gaps(graphs):
        caches = (graphs.caches(size) if graphs is not None else
                  init_kv_caches(cfg, 1, size, quant=kv_quant, device=dev))
        logits, kvs = forward(params, torch.tensor(
            [list(prompt)], dtype=torch.int32, device=dev), cfg,
            return_kv=True)
        _insert_kvs(caches, kvs, 0)
        out = [logits[0, L - 1].max() - logits[0, L - 1, toks[0].long()]]
        lengths = torch.full((1,), L, dtype=torch.int32, device=dev)
        for j in range(n - 1):
            if graphs is not None:
                logits = graphs.step(size, toks[j:j + 1], L + j)
            else:
                logits, caches = decode_step(params, toks[j:j + 1], caches,
                                             lengths, cfg)
                lengths += 1
            out.append(logits[0].max() - logits[0, toks[j + 1].long()])
        return torch.stack(out)

    return held_gap(graphs, gaps)


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def serve_engine(params, cfg, prompts, lone, max_new, max_seq, bucket,
                 kv_quant=None, paged=False, num_pages=None, spec_k=0,
                 draft=None):
    """The Engine serves ``prompts`` (one ragged admission), then ``lone``
    alone (the forward path; None: no lone request). ``spec_k`` and
    ``draft``: speculative mode. Returns timings and the served tokens."""
    from leetcuda_tpu_torch.engine import Engine, EngineConfig

    dev = params["embed"].device
    eng = Engine(params, cfg, EngineConfig(slots=len(prompts),
                                           max_seq=max_seq,
                                           prefill_bucket=bucket,
                                           kv_quant=kv_quant, paged=paged,
                                           page_size=PAGE,
                                           num_pages=num_pages,
                                           spec_k=spec_k),
                 draft=draft, device=dev)
    t0 = time.perf_counter()
    uids = [eng.submit(p, max_new) for p in prompts]
    eng.step()  # admits all of them in one ragged batch, one decode step
    sync(dev)
    t_admit = time.perf_counter() - t0
    ticks = 1
    while eng.waiting or eng.active:
        eng.step()
        ticks += 1
    sync(dev)
    t_batch = time.perf_counter() - t0
    batch_ticks = ticks
    t1 = time.perf_counter()
    if lone is not None:
        uids.append(eng.submit(lone, max_new))  # admits alone: forward path
    while eng.waiting or eng.active:
        eng.step()
        ticks += 1
    sync(dev)
    t_lone = time.perf_counter() - t1
    if eng.recoveries:
        raise AssertionError(f"engine recovered {eng.recoveries} times")
    served = [eng.finished[u].generated for u in uids]
    for u, toks in zip(uids, served):
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"request {u} answered {toks}")
    res = {"engine_batch_s": t_batch, "engine_admit_s": t_admit,
           "engine_ticks": ticks, "lone_request_s": t_lone,
           "engine_tok_s": len(prompts) * max_new / t_batch,
           "kv_bytes": eng.kv_memory_report()["target_bytes"],
           "preemptions": eng.preemptions}
    if spec_k:
        res.update(acceptance_rate=eng.acceptance_rate,
                   accepted=eng._accepted, proposed=eng._proposed,
                   tokens_per_tick=len(prompts) * max_new / batch_ticks,
                   kv_memory=eng.kv_memory_report())
        if not 0 < eng._accepted < eng._proposed:
            raise AssertionError(
                f"speculative engine accepted {eng._accepted} of "
                f"{eng._proposed} proposals: the path exercises only one "
                "side of the accept rule")
    return res, served


def serve_generate(params, cfg, gprompts, g_new, kv_quant=None):
    """``generate`` over ``gprompts``; returns timings and the tokens."""
    from leetcuda_tpu_torch.engine import generate

    dev = params["embed"].device
    t0 = time.perf_counter()
    gtoks = generate(params, cfg, gprompts, g_new, kv_quant=kv_quant,
                     device=dev)
    sync(dev)
    t_gen = time.perf_counter() - t0
    if tuple(gtoks.shape) != (gprompts.shape[0], g_new) or not bool(
            ((gtoks >= 0) & (gtoks < cfg.vocab_size)).all()):
        raise AssertionError(f"generate returned {gtoks}")
    return {"generate_s": t_gen,
            "generate_tok_s": gprompts.shape[0] * g_new / t_gen}, gtoks


def serve_prefix_waves(params, cfg, prefix, waves, max_new, kv_quant, chunk,
                       bucket):
    """Path (g): a paged Engine with the prefix cache and ``prefill_chunk``
    = ``chunk`` serves each wave of requests (``prefix`` + one suffix each)
    to its end before the next is submitted. Returns per-wave ticks, seconds
    until every request of the wave is live, total seconds, prefix pages
    adopted and the ticks that both advanced a filling slot and decoded a
    live one; and the served tokens in submission order."""
    from leetcuda_tpu_torch.engine import Engine, EngineConfig

    dev = params["embed"].device
    eng = Engine(params, cfg, EngineConfig(
        slots=len(waves[0]), max_seq=2048, prefill_bucket=bucket,
        kv_quant=kv_quant, paged=True, page_size=PAGE, prefix_cache=True,
        prefill_chunk=chunk), device=dev)
    res, served = [], []
    for suffixes in waves:
        hits0, t0 = eng.pm.hits, time.perf_counter()
        uids = [eng.submit(prefix + suffix, max_new) for suffix in suffixes]
        ticks = fill_and_decode = 0
        t_live = None
        while eng.waiting or eng.active or eng.filling:
            before = {s: r.n_filled for s, r in eng.filling.items()}
            out = eng.step()
            ticks += 1
            advanced = any(s not in eng.filling or eng.filling[s].n_filled > n
                           for s, n in before.items())
            fill_and_decode += bool(out) and advanced
            if t_live is None and not eng.waiting and not eng.filling:
                sync(dev)
                t_live = time.perf_counter() - t0
        sync(dev)
        res.append({"ticks": ticks, "all_live_s": t_live,
                    "total_s": time.perf_counter() - t0,
                    "prefix_pages_hit": eng.pm.hits - hits0,
                    "fill_and_decode_ticks": fill_and_decode})
        served += [eng.finished[u].generated for u in uids]
    for toks in served:
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_size
                                           for t in toks):
            raise AssertionError(f"path g answered {toks}")
    stats = eng.stats()
    n_prefix_pages = len(prefix) // PAGE
    if stats["prefix_pages_hit"] < n_prefix_pages * len(waves[1]) \
            or res[1]["prefix_pages_hit"] < n_prefix_pages * len(waves[1]):
        raise AssertionError(f"path g: the second wave adopted "
                             f"{res[1]['prefix_pages_hit']} prefix pages")
    if not any(w["fill_and_decode_ticks"] for w in res):
        raise AssertionError("path g: no tick both filled and decoded")
    if eng.recoveries or eng.preemptions:
        raise AssertionError(f"path g: {eng.recoveries} recoveries, "
                             f"{eng.preemptions} preemptions")
    n_tok = sum(len(t) for t in served)
    return {"waves": res, "tok_s": n_tok / sum(w["total_s"] for w in res),
            "prefix_pages_hit": stats["prefix_pages_hit"],
            "prefix_pages_prefilled": stats["prefix_pages_prefilled"],
            "prefix_pages_cached": stats["prefix_pages_cached"],
            "kv_bytes": stats["kv_memory"]["target_bytes"]}, served


def serve_speculative(target, draft, cfg, gprompts, g_new, k, prompts,
                      max_new, bucket):
    """Path (h): ``speculative_generate`` over ``gprompts``; the speculative
    Engine over an int8 contiguous cache serving ``prompts``; one short
    ``speculative_sample_generate``. Returns timings, the generator's
    tokens and the engine's served tokens."""
    from leetcuda_tpu_torch.engine.speculative import (
        speculative_generate, speculative_sample_generate)

    dev = target["embed"].device
    t0 = time.perf_counter()
    gtoks, rate = speculative_generate(target, cfg, draft, cfg, gprompts,
                                       g_new, k=k, device=dev)
    sync(dev)
    t_gen = time.perf_counter() - t0
    if tuple(gtoks.shape) != (gprompts.shape[0], g_new) or not bool(
            ((gtoks >= 0) & (gtoks < cfg.vocab_size)).all()):
        raise AssertionError(f"speculative_generate returned {gtoks}")
    if not 0 < rate < 1:
        raise AssertionError(f"speculative_generate accepted {rate} of its "
                             "proposals")
    eng, served = serve_engine(target, cfg, prompts, None, max_new=max_new,
                               max_seq=2048, bucket=bucket, kv_quant="int8",
                               spec_k=k, draft=(draft, cfg))
    t1 = time.perf_counter()
    stoks, srate = speculative_sample_generate(
        target, cfg, draft, cfg, gprompts[:2], 8,
        torch.Generator(device=dev).manual_seed(0), k=k, temperature=0.8,
        top_k=50, device=dev)
    sync(dev)
    if tuple(stoks.shape) != (2, 8) or not bool(
            ((stoks >= 0) & (stoks < cfg.vocab_size)).all()):
        raise AssertionError(f"speculative_sample_generate returned {stoks}")
    return {"generate_s": t_gen,
            "generate_tok_s": gprompts.shape[0] * g_new / t_gen,
            "generate_acceptance_rate": rate, "engine": eng,
            "sample_s": time.perf_counter() - t1,
            "sample_acceptance_rate": srate}, gtoks, served


def stepwise_gaps(graphs, prefix, tails):
    """Teacher-forced gaps of streams that share ``prefix``: a solo B=1
    replay, token by token through ``decode_step`` (``graphs``, a
    StepGraphs of the path's params and cache type) over a contiguous
    cache, the prefix once (its cache is copied for every stream).
    ``tails``: (suffix, served tokens) per stream."""
    dev = graphs.dev
    n = len(prefix) + max(len(s) + len(t) for s, t in tails)
    n += -n % 128
    caches = graphs.caches(n)
    toks = torch.tensor(prefix, dtype=torch.int32, device=dev)
    for t in range(len(prefix)):
        graphs.step(n, toks[t:t + 1], t)
    snapshot = [{k: v.clone() for k, v in c.items()} for c in caches]
    worst = []
    for suffix, tokens in tails:
        for c, snap in zip(caches, snapshot):
            for k, v in snap.items():
                c[k].copy_(v)
        seq = torch.tensor(list(suffix) + list(tokens), dtype=torch.int32,
                           device=dev)
        gaps = []
        for t in range(len(seq) - 1):
            logits = graphs.step(n, seq[t:t + 1], len(prefix) + t)
            if t >= len(suffix) - 1:
                gaps.append(logits[0].max() - logits[0, seq[t + 1].long()])
        worst.append(float(torch.stack(gaps).max()))
    return worst


def train_corpus(vocab, n, seed):
    """A learnable synthetic corpus, as ``examples/train.py --loader`` makes
    it: a walk along a fixed random permutation, so the next token is a
    function of the current one."""
    perm = np.random.default_rng(seed).permutation(vocab)
    x = np.zeros(n, np.int64)
    for t in range(1, n):
        x[t] = perm[x[t - 1]]
    return x


def crops(corpus, rng, B, S, dev):
    """(B, S) int32 crops of ``corpus`` at random offsets, on ``dev``."""
    starts = rng.integers(0, len(corpus) - S, B)
    return torch.from_numpy(np.stack([corpus[s:s + S] for s in starts])
                            .astype(np.int32)).to(dev)


class PlainBwdFlash(torch.autograd.Function):
    """The model's attention with the plain backward, ``flash_attention_
    bwd_plain``, called explicitly. Its forward is ``flash_attention_plain``
    (``kernel_fwd`` False) or the kernel forward with its lse (True). The
    backward reads the lse times (1 + ``nudge``): 0, or 2**-22 (a few f32
    ulps), a control of how far roundoff alone carries through the model's
    bf16 backward. With a list ``gaps``, it also runs the backward kernels
    on the same inputs and appends their worst relative L2 error against
    the plain backward: the kernels held on the model's own activations.
    ``window`` and ``softcap`` are the layer's, as the model passes them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kernel_fwd, nudge, gaps, window,
                softcap):
        from leetcuda_tpu_torch.attention import flash as fl

        fwd = fl.flash_attention if kernel_fwd else fl.flash_attention_plain
        opt = dict(window=window, softcap=softcap)
        out, lse = fwd(q, k, v, causal=causal, sm_scale=scale, with_lse=True,
                       **opt)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.nudge, ctx.gaps = causal, scale, nudge, gaps
        ctx.opt = opt
        return out

    @staticmethod
    def backward(ctx, do):
        from leetcuda_tpu_torch.attention import flash_bwd as fb

        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        want = fb.flash_attention_bwd_plain(
            q, k, v, out, lse + ctx.nudge * lse, do, causal=ctx.causal,
            sm_scale=ctx.scale, **ctx.opt)
        if ctx.gaps is not None:
            got = fb.flash_attention_bwd(q, k, v, out, lse, do,
                                         causal=ctx.causal, sm_scale=ctx.scale,
                                         **ctx.opt)
            ctx.gaps.append(max(rel_l2(g, w) for g, w in zip(got, want)))
        return (*want, None, None, None, None, None, None, None)


def plain_bwd_trainable(kernel_fwd, nudge=0.0, gaps=None):
    """A stand-in for ``make_flash_attention_trainable`` over
    PlainBwdFlash, for a model without attention sinks (no lse out)."""
    def make(*, causal=False, sm_scale=None, window=None, softcap=None,
             with_lse=False):
        if with_lse:
            raise ValueError("plain_bwd_trainable returns no lse: replay a "
                             "model without attention sinks")

        def fa(q, k, v):
            scale = (sm_scale if sm_scale is not None
                     else 1 / np.sqrt(q.shape[3]))
            return PlainBwdFlash.apply(q, k, v, causal, float(scale),
                                       kernel_fwd, nudge, gaps, window,
                                       softcap)
        return fa
    return make


def replay_train_step(cfg, params, tokens):
    """Path (i)'s check: the loss and every parameter's gradient of one
    step (no remat), through the kernels and three times more with the
    model's attention swapped for PlainBwdFlash: ``plain`` (the plain
    forward and backward); ``plain_bwd`` (the kernel forward and the plain
    backward: only the backward kernels differ from the kernels' run; each
    layer's backward kernels are also held against the plain backward on
    that layer's inputs); ``nudged`` (``plain_bwd`` with the lse nudged by
    a few f32 ulps: roundoff alone, the floor of the gradient gap). Fails
    over REPLAY_LOSS_TOL, REPLAY_GRAD_TOL (against ``plain``),
    REPLAY_BWD_TOL (against ``plain_bwd``), REPLAY_CALL_TOL (per layer), or
    if the kernels' run did not launch each training kernel once per layer
    (forward with lse, dQ, dK/dV)."""
    from leetcuda_tpu_torch.core.runtime import launch_counts
    from leetcuda_tpu_torch.models import llama as tl

    names, leaves = zip(*tl.named_leaves(params))
    kernel_fa = tl.make_flash_attention_trainable

    def run(make_fa):
        tl.make_flash_attention_trainable = make_fa
        try:
            loss = tl.loss_fn(params, tokens, cfg)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)
        finally:
            tl.make_flash_attention_trainable = kernel_fa

    calls = []  # in backward order: layer n_layers - 1 first
    for p in leaves:
        p.requires_grad_(True)
    try:
        before = launch_counts()
        loss_k, grads_k = run(kernel_fa)
        after = launch_counts()
        loss_p, grads_p = run(plain_bwd_trainable(False))
        _, grads_b = run(plain_bwd_trainable(True, gaps=calls))
        _, grads_n = run(plain_bwd_trainable(True, nudge=2.0 ** -22))
    finally:
        for p in leaves:
            p.requires_grad_(False)
    moved = {n: after[n] - before[n] for n in TRAIN_KERNELS}
    if moved != {n: cfg.n_layers for n in TRAIN_KERNELS}:
        raise AssertionError(f"replayed step launched {moved}")
    res = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_err": abs(loss_k / loss_p - 1),
           "call_rel_l2": calls[::-1], "worst_call_rel_l2": max(calls)}
    for ref, a, b in (("plain", grads_k, grads_p),
                      ("plain_bwd", grads_k, grads_b),
                      ("nudged", grads_b, grads_n)):
        errs = {n: rel_l2(x, y) for n, x, y in zip(names, a, b)}
        res[f"grad_rel_l2_{ref}"] = errs
        res[f"worst_grad_{ref}"] = max(errs, key=errs.get)
        res[f"worst_grad_rel_l2_{ref}"] = max(errs.values())
    if res["loss_rel_err"] > REPLAY_LOSS_TOL or not np.isfinite(loss_k):
        raise AssertionError(f"replayed loss {loss_k} against the plain "
                             f"attention's {loss_p}")
    if res["worst_call_rel_l2"] > REPLAY_CALL_TOL:
        raise AssertionError(f"backward kernels off the plain backward on "
                             f"the model's activations: {res['call_rel_l2']}")
    for ref, tol in (("plain", REPLAY_GRAD_TOL),
                     ("plain_bwd", REPLAY_BWD_TOL)):
        if res[f"worst_grad_rel_l2_{ref}"] > tol:
            raise AssertionError(f"replayed gradients off the {ref} "
                                 f"attention's: {res[f'grad_rel_l2_{ref}']}")
    return res


def train(cfg, params, corpus, rng, B=TRAIN_B, S=TRAIN_S, steps=TRAIN_STEPS,
          warmup=TRAIN_WARMUP):
    """Paths (i) and (s): ``steps`` steps of ``make_train_step`` (remat,
    AdamW at TRAIN_LR) at B x S over crops of ``corpus`` uploaded
    beforehand; the first ``warmup`` steps are not timed, and nothing is
    read back until the last step. Asserts finite losses, a fall (mean of
    the last three below the first) and each step's launches: the forward
    with its lse twice per layer (remat), dQ and dK/dV once, nothing else.
    The model FLOPs count each layer's attention over the pairs its band
    keeps. Returns the numbers and (step, opt) for the profile."""
    from leetcuda_tpu_torch.core.runtime import launch_counts
    from leetcuda_tpu_torch.models.llama import make_train_step, named_leaves

    dev = params["embed"].device
    L = cfg.n_layers
    init_opt, step = make_train_step(cfg, learning_rate=TRAIN_LR, remat=True)
    opt = init_opt(params)
    batches = [crops(corpus, rng, B, S, dev) for _ in range(steps)]
    want = {"flash_attention_lse": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}
    losses, t0 = [], None
    for i, tokens in enumerate(batches):
        if i == warmup:
            sync(dev)
            t0 = time.perf_counter()
        before = launch_counts()
        params, opt, loss = step(params, opt, tokens)
        after = launch_counts()
        moved = {n: c - before[n] for n, c in after.items() if c != before[n]}
        if moved != want:
            raise AssertionError(f"training step {i} launched {moved}")
        losses.append(loss)
    sync(dev)
    seconds = time.perf_counter() - t0
    losses = torch.stack(losses).tolist()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training losses {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    n_timed = steps - warmup
    n_params = sum(p.numel() for _, p in named_leaves(params))
    # train_bench.py:61: 6 N, and 3 x 2 products x 2 FLOPs x H x Dh per
    # (row, key) pair a layer's band keeps (S^2 / 2 causal), per token
    pairs = sum(band_pairs(S, cfg.layer_window(i)) if cfg.layer_window(i)
                else S * S / 2 for i in range(L))
    flops_per_tok = (6 * n_params
                     + 3 * 2 * 2 * cfg.n_heads * cfg.head_dim * pairs / S)
    tok_s = n_timed * B * S / seconds
    return {"batch": B, "seq": S, "steps": steps, "lr": TRAIN_LR,
            "remat": True, "losses": losses, "step_s": seconds / n_timed,
            "tok_s": tok_s, "n_params": n_params,
            "model_flop_share": tok_s * flops_per_tok / BF16_FLOP_PER_S,
            "launches_per_step": want}, step, opt, batches[-1]


# --- path (j): the GEMM library -----------------------------------------------

GEMM_SRC = {
    "matmul": ("leetcuda_tpu_torch/csrc/matmul.cu",
               "leetcuda_tpu/gemm/matmul.py:173"),
    "matmul_i8i8i32": ("leetcuda_tpu_torch/csrc/i8_matmul.cu",
                       "leetcuda_tpu/gemm/quant.py:191"),
    "gemv": ("leetcuda_tpu_torch/csrc/gemv.cu",
             "leetcuda_tpu/gemm/gemv.py:64"),
    "rms_norm_gemv": ("leetcuda_tpu_torch/csrc/gemv.cu",
                      "leetcuda_tpu/gemm/gemv.py:127"),
}
GEMM_FAMILIES = ("gemm", "gemv", "gemm-quant")
F32_TOL = dict(atol=1e-3, rtol=1e-3)  # tests/test_gemm.py's f32 bar
EXACT = dict(atol=0, rtol=0)
HEADLINE_MNK = 8192  # bench.py's and the reference's headline shape
LADDER_MNK = 2048
# The JAX tests' ragged shapes (tests/test_gemm.py): every rung takes the
# first; the swizzled rungs the other two, where the group of 4 does not
# divide the tile-column count. (200, 130, 261) has K and N off a multiple
# of 8, so the tensor-core tiles load element by element.
RAGGED_MNK = ((200, 136, 264), (200, 130, 261))
SWIZZLE_MNK = ((512, 256, 2048), (256, 640, 384))
TRAIN_ROWS = TRAIN_B * TRAIN_S  # training's M = B * S = 16384
# matmul_auto's skewed shapes: tests/test_gemm.py:148-151 without 16384^3
SKEWED_MNK = ((8192, 1024, 8192), (1024, 8192, 8192), (4096, 14336, 4096),
              (8192, 8192, 1024), (384, 640, 264))


@contextlib.contextmanager
def uncounted():
    """Launches inside (timing a kernel beside its plain version) leave the
    launch counts as they were."""
    from leetcuda_tpu_torch.core.runtime import _COUNTERS

    saved = {n: c.launches for n, c in _COUNTERS.items()}
    try:
        yield
    finally:
        for n, c in _COUNTERS.items():  # a counter made inside starts at 0
            c.launches = saved.get(n, 0)


def tflops(flops, ms):
    return flops / (ms * 1e-3) / 1e12


class GemmRun:
    """Path (j)'s inputs (a seeded CUDA generator) and its rows: each case
    runs its entry point once (counted), is held against its plain version
    and, unless told otherwise, timed beside it and beside one library call
    (uncounted)."""

    def __init__(self, flush):
        self.flush = flush
        self.gen = torch.Generator(device="cuda").manual_seed(5)
        self.rec = Recorder()
        self.checks = {}  # untimed checks: max abs error

    def rand(self, *shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=self.gen, device="cuda")
                * scale).to(dtype)

    def ints(self, *shape):
        return torch.randint(-128, 128, shape, generator=self.gen,
                             device="cuda", dtype=torch.int8)

    def case(self, check, kernel, call, plain, lib, flops, nbytes, dtype,
             tol=KERNEL_TOL, timed=True, **extra):
        got = call()
        want = plain()
        err = hold(got, want, tol)
        if not timed:
            self.checks[check] = err
            return None
        with uncounted():
            ms = time_ms(call, self.flush)
            plain_ms = time_ms(plain, self.flush, iters=5)
            lib_ms = None if lib is None else time_ms(lib, self.flush)
        src, replaces = GEMM_SRC[kernel]
        self.rec.record(check, kernel, src, replaces, got, want, ms, plain_ms,
                        lib_ms, flops, nbytes, tol=tol, rate=PEAK_RATE[dtype])
        row = self.rec.rows[check]
        row.update(extra, tflops=tflops(flops, ms),
                   gbytes_s=nbytes / (ms * 1e-3) / 1e9,
                   library_tflops=None if lib_ms is None else
                   tflops(flops, lib_ms))
        return row


def _mm_bytes(M, N, K, dtype):
    return float((M * K + K * N + M * N) * dtype.itemsize)


def _mm_case(run, check, fn, M, N, K, dtype, layout="nn", timed=True,
             **extra):
    """One matmul case through ``fn`` on random (M, K) and (K, N) operands
    ((N, K) for layout "tn"), beside torch.matmul in the same dtype."""
    from leetcuda_tpu_torch.gemm.matmul import matmul_plain

    scale = 1.0 if K <= 4096 else 0.5
    x = run.rand(M, K, dtype=dtype, scale=scale)
    y = run.rand(*((K, N) if layout == "nn" else (N, K)), dtype=dtype,
                 scale=scale)
    yl = y if layout == "nn" else y.t()
    tol = F32_TOL if dtype == torch.float32 else KERNEL_TOL
    return run.case(check, "matmul", lambda: fn(x, y),
                    lambda: matmul_plain(x, y, layout),
                    lambda: torch.matmul(x, yl), 2.0 * M * N * K,
                    _mm_bytes(M, N, K, dtype), dtype, tol=tol, timed=timed,
                    M=M, N=N, K=K, **extra)


def interleaved_ms(fns, flush, rounds=5, iters=7):
    """{name: median over ``rounds`` of each function's ``time_ms``}, the
    functions taken in turn within each round, so that a drift of the
    card's clock under sustained load (a later timing of one kernel read up
    to 15% slower than an earlier one in a run) falls on all alike.
    Launches uncounted."""
    times = {name: [] for name in fns}
    with uncounted():
        for _ in range(rounds):
            for name, fn in fns.items():
                times[name].append(time_ms(fn, flush, iters=iters, warmup=1))
    return {name: float(np.median(t)) for name, t in times.items()}


def config_times(run, x, y):
    """Times of every tensor-core instantiation of csrc/matmul.cu, with and
    without a grouped tile walk, on (x, y): the A/B behind
    ``pick_matmul_config``."""
    from leetcuda_tpu_torch.gemm import matmul as mm

    fns = {}
    for blk, (_, path) in mm.BLOCKS.items():
        if path == "tensor-core":
            for g in (None, 8):
                fn = mm.make_matmul(block=blk, swizzle_group=g)
                fns[f"{blk}/{g or 'rows'}"] = lambda fn=fn: fn(x, y)
    return interleaved_ms(fns, run.flush)


def _int_mm(x, w):
    """torch._int_mm as the int8 library yardstick, or None where this
    torch refuses the operands."""
    try:
        torch._int_mm(x, w)
    except (RuntimeError, AttributeError) as e:
        print(f"  torch._int_mm refuses {tuple(x.shape)} x {tuple(w.shape)}:"
              f" {str(e).splitlines()[0]}")
        return None
    return lambda: torch._int_mm(x, w)


def registry_sweep(families, n_ops):
    """Every registered op of the port in ``families`` on the card at its
    ``make_args`` inputs against its registry oracle at its registry
    tolerance (hgemm_w8a8_i32 exactly; both outputs of a tuple), its inputs
    unchanged; the sweep must cover ``n_ops`` ops. Returns {name: max abs
    error}."""
    from leetcuda_tpu_torch.core.registry import OPS, load_all
    from leetcuda_tpu_torch.core.testing import make_args

    load_all()
    rng = np.random.default_rng(0)
    errs = {}
    for name, spec in OPS.items():
        if spec.family not in families:
            continue
        args = make_args(spec, rng, "cuda")
        before = [a.clone() for a in args]
        got, want = spec.fn(*args), spec.ref(*args)
        unchanged(name, args, before)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        errs[name] = max(hold(g, w, dict(atol=spec.atol, rtol=spec.rtol))
                         for g, w in zip(got, want))
    if len(errs) != n_ops:
        raise AssertionError(f"the port registers {len(errs)} ops of "
                             f"{families}, not {n_ops}")
    return errs


def unchanged(what, inputs, before):
    """Fail if a call wrote into one of its inputs: every byte of each as
    it was in ``before`` (its clone), float8 and NaN alike."""
    for t, b in zip(inputs, before):
        if not torch.equal(t.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{what}: an input was written")


def gemm_ladder(run):
    """Path (j), part 2: the headline (``hgemm`` at bf16 and f16 8192^3
    beside torch.matmul), the 12 rungs at 2048^3 in their dtypes, and the
    ragged shapes (every rung; the swizzled rungs also where the group does
    not divide the tile columns; a bf16 rung with an f32 output)."""
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.gemm import matmul as mm

    n = HEADLINE_MNK
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        row = _mm_case(run, f"matmul/hgemm {tag} {n}^3", mm.hgemm, n, n, n,
                       dt, rung="hgemm", block=mm.hgemm.block,
                       swizzle_group=mm.hgemm.swizzle_group)
        if dt == torch.bfloat16:
            row["ms_by_config"] = config_times(
                run, run.rand(n, n, scale=0.5), run.rand(n, n, scale=0.5))
    for name, blk, layout, swz in mm.VARIANTS:
        dt = torch.bfloat16 if name.startswith("hgemm") else torch.float32
        fn = OPS[name].fn
        _mm_case(run, f"matmul/{name} {LADDER_MNK}^3", fn, LADDER_MNK,
                 LADDER_MNK, LADDER_MNK, dt, layout, rung=name, block=blk,
                 swizzle_group=swz)
        shapes = RAGGED_MNK + (SWIZZLE_MNK if swz else ())
        for M, N, K in shapes:
            _mm_case(run, f"matmul/{name} ({M}, {N}, {K})", fn, M, N, K, dt,
                     layout, timed=False)
    M, N, K = RAGGED_MNK[0]
    _mm_case(run, f"matmul/hgemm bf16 -> f32 ({M}, {N}, {K})",
             mm.make_matmul(out_dtype=torch.float32), M, N, K,
             torch.bfloat16, timed=False)


def gemm_model_shapes(run, layer, embed):
    """Path (j), part 3: the full-width ModelConfig()'s shapes. matmul_auto
    at training's rows over layer 0's projections (the output projection:
    ``embed`` transposed) and at the skewed shapes; gemv / hgemv of one
    decode row against those weights (and in f32 and f16 on ``wqkv``, and
    with an epilogue); rms_norm_gemv with the layer's norms (all ones at
    init, so also once with random norm weights); the int8 matmul at 8192^3
    and on the int8 packs of the projections."""
    import torch.nn.functional as F
    from leetcuda_tpu_torch.gemm import gemv as gv
    from leetcuda_tpu_torch.gemm import matmul as mm
    from leetcuda_tpu_torch.gemm import quant as gq

    bf = torch.bfloat16
    weights = {"wqkv": layer["wqkv"], "wo": layer["wo"],
               "w_gate_up": layer["w_gate_up"], "w_down": layer["w_down"],
               "lm_out": embed.t().contiguous()}
    for key, w in weights.items():
        K, N = w.shape
        x = run.rand(TRAIN_ROWS, K)
        cfg = mm.pick_matmul_config(TRAIN_ROWS, N, K, bf)
        row = run.case(
            f"matmul/matmul_auto {key} ({TRAIN_ROWS}, {N}, {K})", "matmul",
            lambda: mm.matmul_auto(x, w), lambda: mm.matmul_plain(x, w),
            lambda: torch.matmul(x, w), 2.0 * TRAIN_ROWS * N * K,
            _mm_bytes(TRAIN_ROWS, N, K, bf), bf, M=TRAIN_ROWS, N=N, K=K,
            rung="matmul_auto", block=cfg["block"],
            swizzle_group=cfg["swizzle_group"])
        row["ms_by_config"] = config_times(run, x, w)
    for M, N, K in SKEWED_MNK:
        cfg = mm.pick_matmul_config(M, N, K, bf)
        row = _mm_case(run, f"matmul/matmul_auto ({M}, {N}, {K})",
                       mm.matmul_auto, M, N, K, bf, rung="matmul_auto",
                       block=cfg["block"], swizzle_group=cfg["swizzle_group"])
        row["ms_by_config"] = config_times(
            run, run.rand(M, K, scale=0.5), run.rand(K, N, scale=0.5))

    gemv_cases = [(name, fn, key, weights[key]) for name, fn in
                  (("gemv", gv.gemv), ("hgemv", gv.hgemv))
                  for key in ("w_gate_up", "wqkv", "w_down", "lm_out")]
    gemv_cases += [("gemv", gv.gemv, f"wqkv {dt}".replace("torch.", ""),
                    layer["wqkv"].to(dt))
                   for dt in (torch.float32, torch.float16)]
    for name, fn, key, w in gemv_cases:
        K, N = w.shape
        x = run.rand(K, dtype=w.dtype)
        isz = w.element_size()
        row = run.case(f"gemv/{name} {key} K={K} N={N}", "gemv",
                       lambda: fn(x, w), lambda: gv.gemv_plain(x, w),
                       lambda: torch.matmul(x.reshape(1, -1), w), 2.0 * K * N,
                       float((K + K * N + N) * isz), w.dtype,
                       tol=F32_TOL if w.dtype == torch.float32 else KERNEL_TOL,
                       K=K, N=N)
        row["ms_by_k_lanes"] = interleaved_ms(  # behind DEFAULT_K_LANES
            {kl: lambda f=gv.make_gemv(k_lanes=kl): f(x, w)
             for kl in gv.K_LANES}, run.flush)
    w = weights["w_gate_up"]
    x = run.rand(w.shape[0])
    silu = gv.make_gemv(epilogue=F.silu)
    run.case("gemv/epilogue silu w_gate_up", "gemv", lambda: silu(x, w),
             lambda: gv.gemv_plain(x, w, F.silu), None, 0.0, 0.0, bf,
             timed=False)

    eps = 1e-5
    for key, norm in (("wqkv", layer["attn_norm"]),
                      ("w_gate_up", layer["mlp_norm"]),
                      ("wqkv, random norm_w", run.rand(2048, scale=0.3) + 1)):
        w = weights[key.split(",")[0]]
        K, N = w.shape
        x = run.rand(K)

        def eager(x=x, norm=norm, w=w):
            xf = x.float()
            xn = xf * torch.rsqrt(xf.square().mean() + eps) * norm.float()
            return torch.matmul(xn.to(bf).reshape(1, -1), w)

        row = run.case(f"rms_norm_gemv/{key} K={K} N={N}", "rms_norm_gemv",
                       lambda: gv.rms_norm_gemv(x, norm, w),
                       lambda: gv.rms_norm_gemv_plain(x, norm, w, eps), None,
                       2.0 * K * N + 4.0 * K, float((2 * K + K * N + N) * 2),
                       bf, K=K, N=N)
        with uncounted():
            row["eager_unfused_ms"] = time_ms(eager, run.flush)
            row["matmul_ms"] = time_ms(
                lambda: torch.matmul(x.reshape(1, -1), w), run.flush)

    n = HEADLINE_MNK
    i8_cases = [(f"{n}^3", run.ints(n, n), run.ints(n, n))]
    i8_cases += [(f"{key} int8 pack", run.ints(TRAIN_ROWS, w.shape[0]),
                  gq.quantize_rowwise_int8(w)[0])
                 for key, w in weights.items()]
    for key, x, w in i8_cases:
        (M, K), N = x.shape, w.shape[1]
        run.case(f"matmul_i8i8i32/{key} ({M}, {N}, {K})", "matmul_i8i8i32",
                 lambda: gq.matmul_i8i8i32(x, w),
                 lambda: gq.matmul_i8i8i32_plain(x, w), _int_mm(x, w),
                 2.0 * M * N * K, float(M * K + K * N + 4 * M * N),
                 torch.int8, tol=EXACT, M=M, N=N, K=K)


def gemm_library(layer, embed, card):
    """Path (j): the GEMM library on the card, in three parts, each driven
    with the launch counts zeroed just before it and read just after.
    Returns (rows for the kernels line, the path's report)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    run = GemmRun(flush)
    res = {"launches": {}}
    t0 = time.perf_counter()
    for part, fn in (("j1", lambda: registry_sweep(GEMM_FAMILIES, 25)),
                     ("j2", lambda: gemm_ladder(run)),
                     ("j3", lambda: gemm_model_shapes(run, layer, embed))):
        out, counts, _ = drive(part, fn)
        if part == "j1":
            res["registry_max_abs_err"] = out
        res[f"launches_{part}"] = counts
        for k, v in counts.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
    res["untimed_checks"] = run.checks
    res["sass"] = resident_sass("matmul")  # wgmma fed by TMA, no mma.sync
    res["seconds"] = time.perf_counter() - t0
    rows = run.rec.rows
    bf, f16 = (rows[f"matmul/hgemm {t} {HEADLINE_MNK}^3"]
               for t in ("bf16", "f16"))
    res["headline"] = {
        "hgemm_bf16_8192cubed_tflops": bf["tflops"],
        "cublas_tflops": bf["library_tflops"],
        "ratio": bf["tflops"] / bf["library_tflops"], "card": card,
        "hgemm_f16_8192cubed_tflops": f16["tflops"],
        "cublas_f16_tflops": f16["library_tflops"]}
    return rows, res


def print_gemm(rows, res):
    print(f"path (j) GEMM library: {len(res['registry_max_abs_err'])} "
          f"registered ops held at their registry tolerances; "
          f"{len(res['untimed_checks'])} ragged / swizzle / epilogue checks; "
          f"{len(rows)} timed cases in {res['seconds']:.1f} s", flush=True)
    for r in rows.values():
        byte_bound = r["bound_by"] == "bytes"
        lib = ("library none [eager unfused "
               f"{r['eager_unfused_ms']:.4f} ms, torch.matmul alone "
               f"{r['matmul_ms']:.4f} ms]" if r["library_ms"] is None else
               f"library {r['library_ms']:.4f} ms" + (
                   "" if byte_bound else
                   f" ({r['library_tflops']:.1f} TFLOPS)"))
        rate = (f"{r['gbytes_s']:.0f} GB/s" if byte_bound
                else f"{r['tflops']:.1f} TFLOPS")
        print(f"  {r['check']}: max_abs_err {r['max_abs_err']:.3g} kernel "
              f"{r['ms']:.4f} ms ({rate}) plain "
              f"{r['plain_ms']:.4f} ms {lib} bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
        for key in ("ms_by_config", "ms_by_k_lanes"):
            if key in r:
                print("    " + ", ".join(f"{k}: {v:.4f}"
                                         for k, v in r[key].items()))
    print(f"  matmul SASS: {res['sass']}")
    print(f"  launches: {res['launches']}")


# --- path (k): the row ops and split-KV attention -----------------------------

ROW_SRC = {
    "rms_norm": ("leetcuda_tpu_torch/csrc/row_ops.cu",
                 "leetcuda_tpu/ops/rms_norm.py:43"),
    "layer_norm": ("leetcuda_tpu_torch/csrc/row_ops.cu",
                   "leetcuda_tpu/ops/layer_norm.py:50"),
    "layer_norm_bwd": ("leetcuda_tpu_torch/csrc/row_ops.cu",
                       "leetcuda_tpu/ops/layer_norm.py:174"),
    "layer_norm_bwd_block": ("leetcuda_tpu_torch/csrc/row_ops.cu",
                             "leetcuda_tpu/ops/layer_norm.py:174"),
    "softmax": ("leetcuda_tpu_torch/csrc/row_ops.cu",
                "leetcuda_tpu/ops/softmax.py:83"),
    "merge_attn_states": ("leetcuda_tpu_torch/csrc/merge_attn.cu",
                          "leetcuda_tpu/ops/merge_attn_states.py:70"),
}
ROW_FAMILIES = ("softmax", "layer-norm", "rms-norm", "attention-utils")
# Rows of the model's shapes: a decode step's 8, training's B * S = 16384;
# 2050 columns put a scalar tail after the last whole vector of every rung
# and start most rows off a 16-byte boundary (a scalar head).
ROW_DIM, TAIL_DIM, TAIL_ROWS = 2048, 2050, 4096
VOCAB_ROWS = 2048  # softmax over 2048 rows of 32000 logits
SPLITS_DECODE, SPLITS_PREFILL = (2, 4, 8), (2, 4)
# 1e3-offset rows against float64: each f32 mean carries ~1e-4 of rounding
# at 1e3, where E[x^2] - mean^2 would be off by ~0.06 in a variance of 1
OFFSET_TOL = dict(atol=2e-3, rtol=2e-3)


def half_or_f32(name):
    """A rung's dtype, as make_args picks it: f16 where the name says so."""
    return torch.float16 if "f16" in name else torch.float32


class RowRun:
    """Path (k)'s (and path (l)'s) inputs (a seeded CUDA generator) and its
    rows: each case runs its entry point once (counted) with its inputs
    checked unchanged, is held against its plain version and, unless told
    otherwise, timed beside it and one library call (uncounted). ``src``
    gives each kernel's source and the JAX kernel it replaces."""

    def __init__(self, flush, src=None):
        self.flush = flush
        self.src = ROW_SRC if src is None else src
        self.gen = torch.Generator(device="cuda").manual_seed(7)
        self.rec = Recorder()
        self.checks = {}  # untimed checks: max abs error
        self.composite = {}  # split-KV: flash and merge launches together

    def rand(self, *shape, dtype=torch.float32, scale=1.0, offset=0.0):
        return (torch.randn(shape, generator=self.gen, device="cuda")
                * scale + offset).to(dtype)

    def case(self, check, kernel, call, plain, lib, nbytes, inputs,
             tol=KERNEL_TOL, timed=True, flops=0.0, rate=F32_FLOP_PER_S,
             **extra):
        before = [t.clone() for t in inputs]
        got = call()
        unchanged(check, inputs, before)
        want = plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        err = max(hold(g, w, tol) for g, w in zip(got, want))
        if not timed:
            self.checks[check] = err
            return None
        with uncounted():
            ms = time_ms(call, self.flush)
            plain_ms = time_ms(plain, self.flush, iters=5)
            lib_ms = None if lib is None else time_ms(lib, self.flush)
        src, replaces = self.src[kernel]
        self.rec.record(check, kernel, src, replaces, got[0], want[0], ms,
                        plain_ms, lib_ms, flops, nbytes, tol=tol, rate=rate)
        row = self.rec.rows[check]
        row.update(extra, max_abs_err=err,
                   gbytes_s=nbytes / (ms * 1e-3) / 1e9)
        return row


def _rms_cases(run, layer):
    """rms_norm on layer 0's attn_norm in bf16 at training's and a decode
    step's rows, every rung at training's rows in its dtype, and every rung
    at (4096, 2050)."""
    import torch.nn.functional as F
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.ops import rms_norm as rms

    K, w = ROW_DIM, layer["attn_norm"]
    for S in (TRAIN_ROWS, 8):  # the kernels line's row first
        x = run.rand(S, K, dtype=torch.bfloat16)
        run.case(f"rms_norm/bf16 ({S}, {K}) attn_norm", "rms_norm",
                 lambda: rms.rms_norm(x, w), lambda: rms.rms_norm_plain(x, w),
                 lambda: F.rms_norm(x, (K,), w, eps=rms.EPS),
                 4.0 * x.numel() + 2 * K, (x, w), flops=4.0 * x.numel(),
                 S=S, K=K, dtype="bf16")
    for S, k_ in ((TRAIN_ROWS, K), (TAIL_ROWS, TAIL_DIM)):
        for name, spec in OPS.items():
            if spec.family != "rms-norm":
                continue
            dt = half_or_f32(name)
            x, wr = run.rand(S, k_, dtype=dt), run.rand(k_, dtype=dt,
                                                        scale=0.5)
            run.case(f"rms_norm/{name} ({S}, {k_})", "rms_norm",
                     lambda: spec.fn(x, wr),
                     lambda: rms.rms_norm_plain(x, wr),
                     lambda: F.rms_norm(x, (k_,), wr, eps=rms.EPS),
                     2.0 * x.numel() * x.element_size()
                     + k_ * wr.element_size(), (x, wr),
                     tol=dict(atol=spec.atol, rtol=spec.rtol),
                     timed=k_ == K, flops=4.0 * x.numel(), rung=name, S=S,
                     K=k_)
    x = run.rand(TAIL_ROWS, TAIL_DIM, dtype=torch.bfloat16)
    wt = run.rand(TAIL_DIM, dtype=torch.bfloat16, scale=0.3, offset=1.0)
    run.case(f"rms_norm/bf16 ({TAIL_ROWS}, {TAIL_DIM})", "rms_norm",
             lambda: rms.rms_norm(x, wt), lambda: rms.rms_norm_plain(x, wt),
             None, 0.0, (x, wt), timed=False)


def _layer_norm_cases(run):
    """layer_norm and its backward at training's rows in bf16, f32 and f16
    with random gamma and beta (the backward on its rows route, twice, bit
    for bit, and in turn with the block route, the earlier kernel), the
    trainable form's gradients against autograd through the plain forward,
    the rows route at K 1024 and 4096 in bf16 and f32 (twice, bit for bit),
    the backward's block route at (4096, 2050) (a K the rows route does not
    take), every rung, and rows offset by 1e3 against float64."""
    import torch.nn.functional as F
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.ops import layer_norm as ln

    K = ROW_DIM
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32"),
                    (torch.float16, "f16")):
        x = run.rand(TRAIN_ROWS, K, dtype=dt)
        g = run.rand(K, dtype=dt, scale=0.3, offset=1.0)
        b = run.rand(K, dtype=dt, scale=0.3)
        dy = run.rand(TRAIN_ROWS, K, dtype=dt)
        tol = F32_TOL if dt == torch.float32 else KERNEL_TOL
        isz = x.element_size()
        run.case(f"layer_norm/{tag} ({TRAIN_ROWS}, {K})", "layer_norm",
                 lambda: ln.layer_norm(x, g, b),
                 lambda: ln.layer_norm_plain(x, g, b),
                 lambda: F.layer_norm(x, (K,), g, b, eps=ln.EPS),
                 2.0 * x.numel() * isz + 2 * K * isz, (x, g, b), tol=tol,
                 flops=8.0 * x.numel(), S=TRAIN_ROWS, K=K, dtype=tag)
        lib_leaves = [t.detach().clone().requires_grad_(True)
                      for t in (x, g, b)]
        y_lib = F.layer_norm(lib_leaves[0], (K,), *lib_leaves[1:],
                             eps=ln.EPS)
        row = run.case(
            f"layer_norm_bwd/{tag} ({TRAIN_ROWS}, {K})", "layer_norm_bwd",
            lambda: ln.layer_norm_bwd(x, g, dy),
            lambda: ln.layer_norm_bwd_plain(x, g, dy),
            lambda: torch.autograd.grad(y_lib, lib_leaves, dy,
                                        retain_graph=True),
            3.0 * x.numel() * isz + 3 * K * isz, (x, g, dy), tol=tol,
            flops=12.0 * x.numel(), S=TRAIN_ROWS, K=K, dtype=tag,
            plan=ln.ln_bwd_plan(TRAIN_ROWS, K, isz))
        first, second = (ln.layer_norm_bwd(x, g, dy) for _ in range(2))
        row["bitwise_repeat"] = all(torch.equal(p, q)
                                    for p, q in zip(first, second))
        if not row["bitwise_repeat"]:
            raise AssertionError(f"layer_norm_bwd {tag}: two runs differ")
        block = ln.ln_bwd_plan(TRAIN_ROWS, K, isz, aligned=False)

        def by_block():
            return ln._launch_bwd(x, g, dy, torch.empty_like(x), block)

        with uncounted():
            row["block_route_max_abs_err"] = max(
                hold(p, q, tol) for p, q in zip(
                    by_block(), ln.layer_norm_bwd_plain(x, g, dy)))
        row["routes_ms"] = interleaved_ms({
            "rows": lambda: ln.layer_norm_bwd(x, g, dy),
            "block": by_block}, run.flush)

        def grads(fn, dy=dy, inputs=(x, g, b)):
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in inputs]
            fn(*leaves).backward(dy)
            return tuple(t.grad for t in leaves)

        run.case(f"layer_norm_trainable/{tag} grads ({TRAIN_ROWS}, {K})",
                 "layer_norm_bwd", lambda: grads(ln.layer_norm_trainable),
                 lambda: grads(ln.layer_norm_plain), None, 0.0,
                 (x, g, b, dy), tol=tol, timed=False)
    # the rows route's other two widths: K 1024 (1 vector a thread) and
    # 4096 (4 vectors, 1 CTA an SM), each twice, bit for bit
    for k_ in (1024, 4096):
        for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = run.rand(TAIL_ROWS, k_, dtype=dt)
            g = run.rand(k_, dtype=dt, scale=0.3, offset=1.0)
            dy = run.rand(TAIL_ROWS, k_, dtype=dt)
            plan = ln.ln_bwd_plan(TAIL_ROWS, k_, x.element_size())
            if plan["route"] != "rows" or plan["nv"] != k_ // 1024:
                raise AssertionError(f"layer_norm_bwd ({TAIL_ROWS}, {k_}): "
                                     f"planned {plan}")
            check = (f"layer_norm_bwd/{tag} ({TAIL_ROWS}, {k_}), "
                     f"{plan['nv']} vectors a thread")
            run.case(check, "layer_norm_bwd",
                     lambda: ln.layer_norm_bwd(x, g, dy),
                     lambda: ln.layer_norm_bwd_plain(x, g, dy), None, 0.0,
                     (x, g, dy), tol=F32_TOL if dt == torch.float32
                     else KERNEL_TOL, timed=False)
            if not all(torch.equal(p, q) for p, q in zip(
                    ln.layer_norm_bwd(x, g, dy), ln.layer_norm_bwd(x, g, dy))):
                raise AssertionError(f"{check}: two runs differ")
    for name, spec in OPS.items():
        if spec.family != "layer-norm":
            continue
        dt = half_or_f32(name)
        x = run.rand(TRAIN_ROWS, K, dtype=dt)
        g, b = run.rand(K, dtype=dt, scale=0.5), run.rand(K, dtype=dt,
                                                          scale=0.5)
        isz = x.element_size()
        run.case(f"layer_norm/{name} ({TRAIN_ROWS}, {K})", "layer_norm",
                 lambda: spec.fn(x, g, b),
                 lambda: ln.layer_norm_plain(x, g, b),
                 lambda: F.layer_norm(x, (K,), g, b, eps=ln.EPS),
                 2.0 * x.numel() * isz + 2 * K * isz, (x, g, b),
                 tol=dict(atol=spec.atol, rtol=spec.rtol),
                 flops=8.0 * x.numel(), rung=name, S=TRAIN_ROWS, K=K)
    x = run.rand(TAIL_ROWS, TAIL_DIM, dtype=torch.bfloat16)
    g = run.rand(TAIL_DIM, dtype=torch.bfloat16, scale=0.3, offset=1.0)
    dy = run.rand(TAIL_ROWS, TAIL_DIM, dtype=torch.bfloat16)
    row = run.case(
        f"layer_norm_bwd/bf16 ({TAIL_ROWS}, {TAIL_DIM}), the block route",
        "layer_norm_bwd_block", lambda: ln.layer_norm_bwd(x, g, dy),
        lambda: ln.layer_norm_bwd_plain(x, g, dy), None,
        6.0 * x.numel() + 6 * TAIL_DIM, (x, g, dy), flops=12.0 * x.numel(),
        S=TAIL_ROWS, K=TAIL_DIM, dtype="bf16",
        plan=ln.ln_bwd_plan(TAIL_ROWS, TAIL_DIM))
    if not all(torch.equal(p, q) for p, q in zip(
            ln.layer_norm_bwd(x, g, dy), ln.layer_norm_bwd(x, g, dy))):
        raise AssertionError("layer_norm_bwd block route: two runs differ")
    x = run.rand(TAIL_ROWS, K, offset=1e3)
    g, b = run.rand(K, scale=0.3, offset=1.0), run.rand(K, scale=0.3)
    run.case(f"layer_norm/f32 rows offset by 1e3 ({TAIL_ROWS}, {K})",
             "layer_norm", lambda: ln.layer_norm(x, g, b),
             lambda: F.layer_norm(x.double(), (K,), g.double(), b.double(),
                                  eps=ln.EPS).float(),
             None, 0.0, (x, g, b), tol=OFFSET_TOL, timed=False)


def _softmax_cases(run):
    """The three softmax forms in f32 at 2048 rows of logits and at a
    decode step's 8, every registered rung at training's rows in its dtype,
    and rows that overflow the naive form (NaN where exp overflows, as in
    its plain version; none in the other two forms)."""
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.ops import softmax as sm

    forms = {"safe": sm.softmax, "online": sm.online_softmax,
             "naive": sm.make_softmax(vec=8, pack=True)}
    tols = {"safe": dict(atol=1e-5, rtol=1e-5),
            "online": dict(atol=1e-5, rtol=1e-5),
            "naive": dict(atol=1e-4, rtol=1e-4)}  # the registry's
    V = 32000
    for S in (VOCAB_ROWS, 8):  # the kernels line's row first
        x = run.rand(S, V, scale=2.0)
        for form, fn in forms.items():
            run.case(f"softmax/{form} f32 ({S}, {V})", "softmax",
                     lambda: fn(x), lambda: sm.PLAIN[fn.mode](x),
                     lambda: torch.softmax(x, dim=-1), 8.0 * x.numel(), (x,),
                     tol=tols[form], flops=5.0 * x.numel(), form=form, S=S,
                     K=V)
    for name, spec in OPS.items():
        if spec.family != "softmax":
            continue
        x = run.rand(TRAIN_ROWS, ROW_DIM, dtype=half_or_f32(name))
        run.case(f"softmax/{name} ({TRAIN_ROWS}, {ROW_DIM})", "softmax",
                 lambda: spec.fn(x), lambda: sm.PLAIN[spec.fn.mode](x),
                 lambda: torch.softmax(x, dim=-1),
                 2.0 * x.numel() * x.element_size(), (x,),
                 tol=dict(atol=spec.atol, rtol=spec.rtol),
                 flops=5.0 * x.numel(), rung=name, S=TRAIN_ROWS, K=ROW_DIM)
    x = run.rand(64, 4001)
    x[1, 7], x[2, :3] = 100.0, 95.0
    before = [x.clone()]
    for form, fn in forms.items():
        got, want = fn(x), sm.PLAIN[fn.mode](x)
        unchanged(f"softmax/{form} overflowing rows", (x,), before)
        nan = got.isnan()
        if not torch.equal(nan, want.isnan()) or (
                form == "naive") != bool(nan.any()):
            raise AssertionError(f"softmax {form}: NaN where its plain "
                                 "version has none, or none where it has")
        run.checks[f"softmax/{form} overflowing rows"] = hold(
            got.nan_to_num(), want.nan_to_num(), tols[form])


def row_ops_shapes(run, layer):
    """Path (k), part 2: the norms and softmax at the full-width model's
    shapes."""
    _rms_cases(run, layer)
    _layer_norm_cases(run)
    _softmax_cases(run)


def splitkv_and_merge(run):
    """Path (k), part 3: flash_attention_splitkv at decode (B = 8, one query
    row) and prefill (B = 1, 2048 rows) over 2048 keys, 16 / 4 heads, head
    dim 128, in bf16, held against the plain attention and against the
    port's unsplit flash forward, each call launching num_splits flash
    forwards with their lse and num_splits - 1 merges; the flash forward
    with its lse at each split's key count first, against its plain version
    (at Nq = 1 its query tile is almost all padding); then
    merge_attn_states alone at the prefill merge's shape and with empty and
    NaN lse."""
    from leetcuda_tpu_torch.attention import flash as fl
    from leetcuda_tpu_torch.attention.splitkv import flash_attention_splitkv
    from leetcuda_tpu_torch.core.runtime import launch_counts
    from leetcuda_tpu_torch.ops import merge_attn_states as mg

    bf = torch.bfloat16
    H, Hkv, N, D = 16, 4, 2048, 128
    for B, Nq, splits in ((8, 1, SPLITS_DECODE), (1, N, SPLITS_PREFILL)):
        q = run.rand(B, H, Nq, D, dtype=bf)
        k, v = run.rand(B, Hkv, N, D, dtype=bf), run.rand(B, Hkv, N, D,
                                                          dtype=bf)
        with uncounted():
            for nk in sorted({N // s for s in splits} | {N}):
                ks, vs = k[:, :, :nk].contiguous(), v[:, :, :nk].contiguous()
                got = fl.flash_attention(q, ks, vs, with_lse=True)
                want = fl.flash_attention_plain(q, ks, vs, with_lse=True)
                run.checks[f"flash_attention_lse/B={B} Nq={Nq} Nk={nk}"] = \
                    max(hold(got[0], want[0]), hold(got[1], want[1]))
            unsplit = fl.flash_attention(q, k, v)
        want = fl.flash_attention_plain(q, k, v)
        for s in splits:
            before = [t.clone() for t in (q, k, v)]
            counts0 = launch_counts()
            got = flash_attention_splitkv(q, k, v, num_splits=s)
            counts1 = launch_counts()
            unchanged("flash_attention_splitkv", (q, k, v), before)
            made = {n: counts1[n] - counts0[n] for n in counts1
                    if counts1[n] != counts0[n]}
            if made != {"flash_attention_lse": s, "merge_attn_states": s - 1}:
                raise AssertionError(f"split-KV num_splits={s} launched "
                                     f"{made}")
            err, err_unsplit = hold(got, want), hold(got, unsplit)
            with uncounted():
                ms = time_ms(lambda: flash_attention_splitkv(
                    q, k, v, num_splits=s), run.flush)
                times = {
                    "plain_ms": time_ms(lambda: fl.flash_attention_plain(
                        q, k, v), run.flush, iters=5),
                    "unsplit_flash_ms": time_ms(
                        lambda: fl.flash_attention(q, k, v), run.flush),
                    "library_ms": time_ms(lambda: sdpa(q, k, v), run.flush)}
            b_s, by = bound(4.0 * B * H * Nq * N * D,
                            2.0 * (2 * B * H * Nq * D + 2 * B * Hkv * N * D))
            run.composite[f"splitkv/B={B} Nq={Nq} num_splits={s}"] = {
                "max_abs_err": err, "max_abs_err_vs_unsplit": err_unsplit,
                "ms": ms, **times, "bound_ms": b_s * 1e3, "bound_by": by,
                "launches": made}

    T = N
    po, so = run.rand(T, H, D, dtype=bf), run.rand(T, H, D, dtype=bf)
    pl, sl = (run.rand(T, H, scale=2.0, offset=5.0) for _ in range(2))
    run.case(f"merge_attn_states/bf16 ({T}, {H}, {D})", "merge_attn_states",
             lambda: mg.merge_attn_states(po, pl, so, sl),
             lambda: mg.merge_attn_states_plain(po, pl, so, sl), None,
             3.0 * T * H * D * 2 + 3.0 * T * H * 4, (po, pl, so, sl),
             flops=6.0 * T * H * D, T=T, H=H, D=D)
    inf, nan = float("inf"), float("nan")
    po, so = po[:64], so[:64]
    for case, (fp, fs) in {"prefix empty": (-inf, None),
                           "suffix empty": (None, inf),
                           "both empty": (-inf, -inf),
                           "nan": (nan, None)}.items():
        a, b = pl[:64].clone(), sl[:64].clone()
        if fp is not None:
            a[::2] = fp
        if fs is not None:
            b[::2] = fs
        run.case(f"merge_attn_states/{case}", "merge_attn_states",
                 lambda: mg.merge_attn_states(po, a, so, b),
                 lambda: mg.merge_attn_states_plain(po, a, so, b),
                 None, 0.0, (po, a, so, b), timed=False)


def row_ops_path(layer):
    """Path (k): the row ops and split-KV attention on the card, in three
    parts, each driven with the launch counts zeroed just before it and read
    just after. Returns (rows for the kernels line, the path's report)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    run = RowRun(flush)
    res = {"launches": {}}
    t0 = time.perf_counter()
    for part, fn in (("k1", lambda: registry_sweep(ROW_FAMILIES, 27)),
                     ("k2", lambda: row_ops_shapes(run, layer)),
                     ("k3", lambda: splitkv_and_merge(run))):
        out, counts, _ = drive(part, fn)
        if part == "k1":
            res["registry_max_abs_err"] = out
        res[f"launches_{part}"] = counts
        for k, v in counts.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
    res.update(untimed_checks=run.checks, splitkv=run.composite,
               seconds=time.perf_counter() - t0)
    return run.rec.rows, res


def print_row_ops(rows, res):
    print(f"path (k) row ops and split-KV: "
          f"{len(res['registry_max_abs_err'])} registered ops held at their "
          f"registry tolerances; {len(res['untimed_checks'])} untimed checks;"
          f" {len(rows)} timed cases in {res['seconds']:.1f} s", flush=True)
    for r in rows.values():
        lib = ("library none" if r["library_ms"] is None
               else f"library {r['library_ms']:.4f} ms")
        rep = ("" if "bitwise_repeat" not in r
               else f"; repeat bit for bit {r['bitwise_repeat']}")
        if "routes_ms" in r:
            rep += (f"; in turn: rows route {r['routes_ms']['rows']:.4f} ms, "
                    f"block route {r['routes_ms']['block']:.4f} ms (max abs "
                    f"{r['block_route_max_abs_err']:.3g})")
        print(f"  {r['check']}: max_abs_err {r['max_abs_err']:.3g} kernel "
              f"{r['ms']:.4f} ms ({r['gbytes_s']:.0f} GB/s) plain "
              f"{r['plain_ms']:.4f} ms {lib} bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){rep}", flush=True)
    for name, r in res["splitkv"].items():
        print(f"  {name}: max_abs_err {r['max_abs_err']:.3g} (against the "
              f"unsplit kernel {r['max_abs_err_vs_unsplit']:.3g}) "
              f"{r['ms']:.4f} ms, unsplit flash {r['unsplit_flash_ms']:.4f} "
              f"ms, plain {r['plain_ms']:.4f} ms, SDPA "
              f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); launches {r['launches']}", flush=True)
    print(f"  untimed checks, max abs error: {res['untimed_checks']}")
    print(f"  launches: {res['launches']}")


# --- path (l): the op corpus's transpose, gathers, RoPE and resident chain -----

CORPUS_SRC = {
    "transpose": ("leetcuda_tpu_torch/csrc/transpose.cu",
                  "leetcuda_tpu/ops/transpose.py:71"),
    "embedding": ("leetcuda_tpu_torch/csrc/embedding.cu",
                  "leetcuda_tpu/ops/embedding.py:76"),
    "embedding_tiled": ("leetcuda_tpu_torch/csrc/embedding.cu",
                        "leetcuda_tpu/ops/embedding.py:141"),
    "rope": ("leetcuda_tpu_torch/csrc/rope.cu", "leetcuda_tpu/ops/rope.py:57"),
    "rope_lane": ("leetcuda_tpu_torch/csrc/rope.cu",
                  "leetcuda_tpu/ops/rope.py:105"),
    "matmul_resident": ("leetcuda_tpu_torch/csrc/matmul_resident.cu",
                        "leetcuda_tpu/gemm/matmul.py:412"),
}
CORPUS_FAMILIES = ("transpose", "embedding", "rope", "gemm-resident")
# RoPE at 65536 positions (where the TPU kernels' exp-form frequencies would
# be off by ~4e-3) and at the model's width over 4096 rows; the transpose at
# 8192^2 f32 (537 MB moved, past the L2) and ragged; the resident chain at
# JAX's ablation setting (RESIDENT_ABLATE.json: 4096^3 bf16, 5 reps).
ROPE_SHAPES = ((65536, 128), (4096, 2048))
TRANSPOSE_DIM, RAGGED_T = 8192, (4097, 3001)
RESIDENT_DIM, RESIDENT_REPS, RESIDENT_SMALL = 4096, 5, 1024
# a (M, N) with N % 8 != 0: a and b zero-padded to N8 by the wrapper (no
# tensor map takes rows of 2060 bytes), a partial last row block and a
# partial last column tile; and more tiles in a rep (33 x 8) than CTAs,
# with a last row block of one row, at 3 reps.
RESIDENT_RAGGED, RESIDENT_TALL = (1000, 1030), (4097, 2048)
# The registry's; A is drawn at unit scale and B at N^-0.5, so every rep's
# output has RMS ~1 and 2e-2 is a few bf16 ulps there.
RESIDENT_TOL = dict(atol=2e-2, rtol=2e-2)


def bits(t):
    """A tensor as the integers of its bytes, for bit-for-bit checks."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _embedding_cases(run, embed):
    """The model's table (``embed``, (32000, 2048) bf16) gathered at
    training's ids and a decode step's, directly and through the serving
    view, bit for bit; every registered rung at training's ids over a table
    of the rung's dtype and width."""
    import torch.nn.functional as F
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.ops import embedding as em

    V, D = embed.shape
    isz = embed.element_size()
    view = em.to_serving_layout(embed)
    for S in (TRAIN_ROWS, 8):  # the kernels line's row first
        ids = torch.randint(0, V, (S,), generator=run.gen, device="cuda",
                            dtype=torch.int32)
        run.case(f"embedding/bf16 {S} ids of ({V}, {D})", "embedding",
                 lambda: bits(em.embedding(ids, embed)),
                 lambda: bits(em.embedding_plain(ids, embed)),
                 lambda: F.embedding(ids, embed), 2.0 * S * D * isz,
                 (ids, embed), tol=EXACT, S=S, V=V, D=D)
        run.case(f"embedding_tiled/bf16 {S} ids of ({V}, {D // 128}, 128)",
                 "embedding_tiled",
                 lambda: bits(em.embedding_serving(ids, embed)),
                 lambda: bits(em.embedding_plain(ids, embed)),
                 lambda: F.embedding(ids, embed), 2.0 * S * D * isz,
                 (ids, embed), tol=EXACT, S=S, V=V, D=D)
    ids = torch.randint(0, V, (TRAIN_ROWS,), generator=run.gen, device="cuda",
                        dtype=torch.int32)
    for name, spec in OPS.items():
        if spec.family != "embedding":
            continue
        dt = (torch.bfloat16 if "bf16" in name else torch.float16
              if "f16" in name else torch.float32)
        table = run.rand(V, D, dtype=dt)
        arg = em.to_serving_layout(table) if "tiled" in spec.tags else table
        run.case(f"{'embedding_tiled' if 'tiled' in spec.tags else 'embedding'}"
                 f"/{name} {TRAIN_ROWS} ids",
                 "embedding_tiled" if "tiled" in spec.tags else "embedding",
                 lambda: bits(spec.fn(ids, arg)),
                 lambda: bits(em.embedding_plain(ids, arg)),
                 lambda: F.embedding(ids, table),
                 2.0 * TRAIN_ROWS * D * table.element_size(), (ids, arg),
                 tol=EXACT, rung=name, S=TRAIN_ROWS, V=V, D=D)


def _rope_cases(run):
    """Every RoPE rung in f32 at 65536 rows of 128 and 4096 rows of 2048,
    at the registry's 1e-4."""
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.ops import rope as rp

    for S, D in ROPE_SHAPES:
        x = run.rand(S, D)
        for name, spec in OPS.items():
            if spec.family != "rope":
                continue
            run.case(f"{'rope_lane' if 'lane' in spec.tags else 'rope'}/"
                     f"{name} ({S}, {D})",
                     "rope_lane" if "lane" in spec.tags else "rope",
                     lambda: spec.fn(x), lambda: rp.rope_plain(x), None,
                     2.0 * x.numel() * 4, (x,),
                     tol=dict(atol=spec.atol, rtol=spec.rtol),
                     flops=6.0 * x.numel(), rung=name, S=S, D=D)


def _transpose_cases(run):
    """mat_transpose and every rung at 8192^2 f32, bit for bit, beside
    ``x.t().contiguous()`` (which is also the plain version)."""
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.ops import transpose as tr

    n = TRANSPOSE_DIM
    x = run.rand(n, n)
    fns = {"mat_transpose": tr.mat_transpose,
           **{name: spec.fn for name, spec in OPS.items()
              if spec.family == "transpose"}}
    for name, fn in fns.items():
        run.case(f"transpose/{name} ({n}, {n})", "transpose",
                 lambda: bits(fn(x)), lambda: bits(tr.transpose_plain(x)),
                 lambda: x.t().contiguous(), 2.0 * x.numel() * 4, (x,),
                 tol=EXACT, rung=name, variant=fn.variant, order=fn.order,
                 S=n, K=n)


def _resident_cases(run):
    """The resident chain at 4096^3 bf16, 5 reps, beside 5 torch.matmul
    (the library) and 5 of the port's hgemm (uncounted)."""
    from leetcuda_tpu_torch.gemm import matmul as mm

    n, reps = RESIDENT_DIM, RESIDENT_REPS
    a = run.rand(n, n, dtype=torch.bfloat16)
    b = run.rand(n, n, dtype=torch.bfloat16, scale=n ** -0.5)
    chain = mm.make_matmul_resident(reps=reps)

    def lib():
        c = a
        for _ in range(reps):
            c = torch.matmul(c, b)
        return c

    def hgemm5():
        c = a
        for _ in range(reps):
            c = mm.hgemm(c, b)
        return c

    tile, co_resident = mm.resident_build_info(a.device)
    plan = mm.resident_plan(n, n, reps, ctas=co_resident, tile=tile)
    row = run.case(f"matmul_resident/bf16 {n}^3 reps {reps}",
                   "matmul_resident", lambda: chain(a, b),
                   lambda: mm.matmul_chain_plain(a, b, reps), lib,
                   3.0 * n * n * 2, (a, b), tol=RESIDENT_TOL,
                   flops=2.0 * reps * n ** 3, rate=BF16_FLOP_PER_S,
                   M=n, reps=reps, ctas=plan["grid"], plan=plan,
                   co_resident_ctas=co_resident)
    with uncounted():
        row["hgemm_x5_ms"] = time_ms(hgemm5, run.flush)
        row["max_abs_err_vs_library"] = float(
            (chain(a, b).float() - lib().float()).abs().max())
    row.update(tflops=tflops(row["flops"], row["ms"]),
               share_of_bound=row["bound_ms"] / row["ms"],
               x_library=row["ms"] / row["library_ms"],
               x_hgemm5=row["ms"] / row["hgemm_x5_ms"])


def corpus_shapes(run, embed):
    """Path (l), part 2: the gathers, RoPE, the transpose and the resident
    chain at full size, timed."""
    _embedding_cases(run, embed)
    _rope_cases(run)
    _transpose_cases(run)
    _resident_cases(run)


def corpus_checks(run, embed):
    """Path (l), part 3, untimed: the transpose's rungs on a ragged shape in
    f32, bf16 and bytes; ids that clamp, NaN rows and int64 ids; RoPE in
    bf16; the resident chain in f16 and f32 at 1024^2, and in bf16 and f32
    at the ragged (1000, 1030), 1 and 4 reps."""
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.gemm import matmul as mm
    from leetcuda_tpu_torch.ops import embedding as em
    from leetcuda_tpu_torch.ops import rope as rp
    from leetcuda_tpu_torch.ops import transpose as tr

    x32 = run.rand(*RAGGED_T)
    for dt, x in (("f32", x32), ("bf16", x32.to(torch.bfloat16)),
                  ("u8", bits(x32).to(torch.uint8))):
        for name, spec in OPS.items():
            if spec.family == "transpose":
                run.case(f"transpose/{name} {dt} {RAGGED_T}", "transpose",
                         lambda: bits(spec.fn(x)),
                         lambda: bits(tr.transpose_plain(x)), None, 0.0,
                         (x,), tol=EXACT, timed=False)

    V, D = embed.shape
    ids = torch.randint(0, V, (64,), generator=run.gen, device="cuda",
                        dtype=torch.int32)
    ids[:6] = torch.tensor([-1, -7, V, V + 50, 0, V - 1], device="cuda")
    table = embed.clone()
    nan_bits = torch.tensor([0x7FC1, 0x7F81, -0x003F, 0x7FFF],
                            dtype=torch.int16, device="cuda")
    bits(table)[5, :4] = nan_bits  # NaNs with distinct payloads
    ids[10:14] = 5
    for what, idx in (("int32", ids), ("int64", ids.long())):
        run.case(f"embedding/clamped ids and NaN rows, {what}", "embedding",
                 lambda: bits(em.embedding(idx, table)),
                 lambda: bits(em.embedding_plain(idx, table)), None, 0.0,
                 (idx, table), tol=EXACT, timed=False)
        run.case(f"embedding_tiled/clamped ids and NaN rows, {what}",
                 "embedding_tiled",
                 lambda: bits(em.embedding_serving(idx, table)),
                 lambda: bits(em.embedding_plain(idx, table)), None, 0.0,
                 (idx, table), tol=EXACT, timed=False)
    got = bits(em.embedding(ids, table))
    if not (torch.equal(got[0], bits(table)[0])
            and torch.equal(got[2], bits(table)[V - 1])
            and torch.equal(got[10, :4], nan_bits)):
        raise AssertionError("embedding: ids did not clamp to the table's "
                             "ends, or a NaN payload changed")

    x = run.rand(2048, 128, dtype=torch.bfloat16)
    run.case("rope_lane/bf16 (2048, 128)", "rope_lane", lambda: rp.rope(x),
             lambda: rp.rope_plain(x), None, 0.0, (x,), timed=False)

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the f32 plain chain must not take TF32")
    for (m, n), dt, tol in (
            ((RESIDENT_SMALL, RESIDENT_SMALL), torch.float16, RESIDENT_TOL),
            ((RESIDENT_SMALL, RESIDENT_SMALL), torch.float32, F32_TOL),
            (RESIDENT_RAGGED, torch.bfloat16, RESIDENT_TOL),
            (RESIDENT_RAGGED, torch.float32, F32_TOL)):
        a = run.rand(m, n, dtype=dt)
        b = run.rand(n, n, dtype=dt, scale=n ** -0.5)
        for reps in (1, 4):
            run.case(f"matmul_resident/{dt} ({m}, {n}) reps {reps}",
                     "matmul_resident",
                     lambda: mm.make_matmul_resident(reps=reps)(a, b),
                     lambda: mm.matmul_chain_plain(a, b, reps), None, 0.0,
                     (a, b), tol=tol, timed=False)
    resident_checks(run)


def resident_checks(run):
    """The one-launch chain's own controls, bit for bit where the kernel must
    repeat itself: reps 5 in one launch against five launches at reps 1
    (the counters' waits and the proxy fences: a stale row shows here) at
    4096^3 and at the padded (1000, 1030); two calls in a row and a
    CUDA-graph capture replayed twice, against the eager call; the chain at
    (4097, 2048), 3 reps, against the plain chain; and a control that must
    fail: reps 5 against the plain chain at reps 4 misses RESIDENT_TOL."""
    from leetcuda_tpu_torch.gemm import matmul as mm

    def exact(check, got, want):
        if not torch.equal(bits(got), bits(want)):
            n_bad = int((bits(got) != bits(want)).sum())
            raise AssertionError(f"{check}: {n_bad} elements differ")
        run.checks[check] = 0.0

    m, n = RESIDENT_TALL
    a = run.rand(m, n, dtype=torch.bfloat16)
    b = run.rand(n, n, dtype=torch.bfloat16, scale=n ** -0.5)
    run.case(f"matmul_resident/bf16 {RESIDENT_TALL} reps 3",
             "matmul_resident", lambda: mm.make_matmul_resident(reps=3)(a, b),
             lambda: mm.matmul_chain_plain(a, b, 3), None, 0.0, (a, b),
             tol=RESIDENT_TOL, timed=False)
    one = mm.make_matmul_resident(reps=1)
    chain = mm.make_matmul_resident(reps=RESIDENT_REPS)
    for m, n in ((RESIDENT_DIM, RESIDENT_DIM), RESIDENT_RAGGED):
        a = run.rand(m, n, dtype=torch.bfloat16)
        b = run.rand(n, n, dtype=torch.bfloat16, scale=n ** -0.5)
        got = chain(a, b)
        c = a
        for _ in range(RESIDENT_REPS):
            c = one(c, b)
        exact(f"matmul_resident/({m}, {n}) reps {RESIDENT_REPS} against "
              f"{RESIDENT_REPS} launches at reps 1", got, c)
    exact("matmul_resident/a second call", chain(a, b), got)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        chain(a, b)  # warm-up on the capturing stream
        with torch.cuda.graph(graph):
            captured = chain(a, b)
    torch.cuda.current_stream().wait_stream(side)
    for k in (1, 2):
        graph.replay()
        exact(f"matmul_resident/graph replay {k}", captured, got)
    short = mm.matmul_chain_plain(a, b, RESIDENT_REPS - 1)
    err = float((got.float() - short.float()).abs().max())
    if torch.allclose(got.float(), short.float(), **RESIDENT_TOL):
        raise AssertionError(f"matmul_resident: reps {RESIDENT_REPS} passes "
                             f"against the plain chain at reps "
                             f"{RESIDENT_REPS - 1} (max abs {err:.3g})")
    run.checks["matmul_resident/control: reps 5 against plain reps 4 "
               "(must miss 2e-2)"] = err


def ptxas_entries(log, needle):
    """The ``-Xptxas -v`` report of the kernels whose mangled names hold
    ``needle``: [{kernel, registers, spill_stores, spill_loads}]."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)} if needle in m.group(1) else None
            if cur:
                out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                cur.update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
    return out


def resident_sass(name="matmul_resident", function=None):
    """Counts of wgmma (HGMMA), mma.sync (HMMA) and TMA load (UTMALDG)
    instructions in the SASS of ``csrc/<name>.cu``'s library (the resident
    chain's, the flash kernels', the quantized matmuls', the matmul
    library's, the grouped matmul's), or of its functions whose names hold
    ``function``: they must run on wgmma fed by TMA and keep no mma.sync
    route."""
    from leetcuda_tpu_torch.build import _lib_path, _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    if function is not None:
        sass = "".join(part for part in sass.split("Function : ")[1:]
                       if function in part.split("\n", 1)[0])
    counts = {op: len(re.findall(rf"\b{op}\b", sass))
              for op in ("HGMMA", "HMMA", "UTMALDG")}
    if counts["HGMMA"] == 0 or counts["UTMALDG"] == 0 or counts["HMMA"]:
        raise AssertionError(f"{name}'s SASS ({function or 'every kernel'}):"
                             f" {counts}; it must be wgmma fed by TMA, with "
                             "no mma.sync")
    return counts


def corpus_path(embed):
    """Path (l): the op corpus's transpose, embedding gathers, RoPE and
    resident matmul chain on the card, in three parts, each driven with the
    launch counts zeroed just before it and read just after. Returns (rows
    for the kernels line, the path's report)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    run = RowRun(flush, src=CORPUS_SRC)
    res = {"launches": {}}
    t0 = time.perf_counter()
    for part, fn in (("l1", lambda: registry_sweep(CORPUS_FAMILIES, 24)),
                     ("l2", lambda: corpus_shapes(run, embed)),
                     ("l3", lambda: corpus_checks(run, embed))):
        out, counts, _ = drive(part, fn)
        if part == "l1":
            res["registry_max_abs_err"] = out
        res[f"launches_{part}"] = counts
        for k, v in counts.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
    res.update(untimed_checks=run.checks, seconds=time.perf_counter() - t0,
               resident_sass=resident_sass())
    return run.rec.rows, res


def print_corpus(rows, res):
    print(f"path (l) transpose, embedding, RoPE, resident chain: "
          f"{len(res['registry_max_abs_err'])} registered ops held at their "
          f"registry tolerances; {len(res['untimed_checks'])} untimed checks;"
          f" {len(rows)} timed cases in {res['seconds']:.1f} s", flush=True)
    for r in rows.values():
        lib = ("library none" if r["library_ms"] is None
               else f"library {r['library_ms']:.4f} ms")
        extra = ("" if "hgemm_x5_ms" not in r else
                 f"; {r['tflops']:.1f} TFLOP/s, {r['share_of_bound']:.3f} of "
                 f"the bound, {r['x_library']:.2f}x the library's time and "
                 f"{r['x_hgemm5']:.3f}x 5 x hgemm ({r['hgemm_x5_ms']:.4f} "
                 f"ms), grid {r['ctas']} CTAs of {r['co_resident_ctas']} "
                 f"co-resident, tile {r['plan']['block_m']} x "
                 f"{r['plan']['block_n']} x {r['plan']['block_k']}, "
                 f"{r['plan']['stages']} stages, cluster "
                 f"{r['plan']['cluster']}, {r['plan']['tiles']} tiles; "
                 f"max_abs_err against the library "
                 f"{r['max_abs_err_vs_library']:.3g}")
        print(f"  {r['check']}: max_abs_err {r['max_abs_err']:.3g} kernel "
              f"{r['ms']:.4f} ms ({r['gbytes_s']:.0f} GB/s) plain "
              f"{r['plain_ms']:.4f} ms {lib} bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){extra}", flush=True)
    print(f"  untimed checks, max abs error: {res['untimed_checks']}")
    print(f"  matmul_resident SASS: {res['resident_sass']}")
    print(f"  launches: {res['launches']}")


# --- path (m): the op corpus's add, activations, reductions, dot, histogram ----

FLAT_SRC = {
    "elementwise_add": ("leetcuda_tpu_torch/csrc/elementwise.cu",
                        "leetcuda_tpu/ops/elementwise.py:62"),
    "activation": ("leetcuda_tpu_torch/csrc/elementwise.cu",
                   "leetcuda_tpu/ops/activations.py:99"),
    "block_all_reduce_sum": ("leetcuda_tpu_torch/csrc/reduce.cu",
                             "leetcuda_tpu/ops/reduce.py:103"),
    "block_all_reduce_max": ("leetcuda_tpu_torch/csrc/reduce.cu",
                             "leetcuda_tpu/ops/reduce.py:143"),
    "dot_product": ("leetcuda_tpu_torch/csrc/reduce.cu",
                    "leetcuda_tpu/ops/dot_product.py:56"),
    "histogram": ("leetcuda_tpu_torch/csrc/histogram.cu",
                  "leetcuda_tpu/ops/histogram.py:42"),
}
FLAT_FAMILIES = ("elementwise", "activation", "reduce", "dot-product",
                 "histogram")
FLAT_KERNEL = {"elementwise": "elementwise_add", "activation": "activation",
               "reduce": "block_all_reduce_sum", "dot-product": "dot_product",
               "histogram": "histogram"}
# Training's residual stream (B * S, dim) and FFN hidden (B * S, ffn); every
# rung of the add and the activations at 4096^2 (the reference harness's
# largest); the reductions at the residual stream's shape; ragged shapes
# (ROADMAP's two reduce shapes, a tail-only one, a single element) and one
# shape with every operand one element past an aligned base.
MODEL_DIM, FFN_DIM, FLAT_DIM = 2048, 5632, 4096
FLAT_RAGGED = (((700, 4000), 0), ((1300, 2500), 0), ((3, 130), 0),
               ((1, 1), 0), ((1300, 2500), 1))
VOCAB_BINS = 32000  # the model's vocabulary: a histogram of token ids
# Llama 3's vocabulary (its config's vocab_size): more bins than an H100's
# opt-in shared memory holds (58112 int32), so the device-memory branch
LARGE_VOCAB_BINS = 128256
# Faster R-CNN's region proposals at test time (Ren et al., NeurIPS 2015,
# section 3.1.1; py-faster-rcnn's TEST config): anchors of 3 sizes (128,
# 256, 512) and 3 ratios (1:2, 1:1, 2:1) at stride 16 over a 600 x 1000
# image, RPN_PRE_NMS_TOP_N 6000 (and 1000), RPN_NMS_THRESH 0.7. Integer
# box corners in the image, so that f32 and float64 IoUs fall on one side
# of the threshold (p / q != 0.7 stands 1 / (10 q) > 7.2e-8 off it for
# unions q below 1.39e6, past f32's rounding of the IoU and of 0.7)
NMS_BOXES, NMS_THRESHOLD = (1000, 6000), 0.7
RPN_IMAGE, RPN_STRIDE = (600, 1000), 16
# NaN, infinities, signed zeros and the points where the activations
# change form (the sigmoid clamp, hardswish's knees, hardshrink's lambda)
SPECIALS = (float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 1.0, -1.0,
            0.5, -0.5, 0.25, 3.0, -3.0, 6.0, -6.0, 88.0, 88.5, -88.0, -88.5,
            100.0, -100.0, 1e30, -1e30, 1e-30, -1e-30)


def _act_library():
    import torch.nn.functional as F

    return {"relu": torch.relu, "sigmoid": torch.sigmoid,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "swish": F.silu, "elu": F.elu, "hardswish": F.hardswish,
            "hardshrink": lambda x: F.hardshrink(x, 0.5)}


def flat_dtype(spec):
    """The element dtype of a path (m) op's inputs, as make_args picks it."""
    from leetcuda_tpu_torch.ops.reduce import _MATRIX

    if spec.family == "reduce":
        return {sfx: e for sfx, e, _, _ in _MATRIX}[spec.tags[0]]
    if spec.family == "dot-product":
        return half_or_f32(spec.name)
    if spec.family == "histogram":
        return torch.int32
    tags = spec.tags
    return (torch.bfloat16 if "bf16" in tags else torch.float16
            if "f16" in tags else torch.float32)


def flat_args(run, spec, shape, offset=0):
    """Inputs of a path (m) op at ``shape``, drawn as make_args draws them:
    unit normal for the add and the activations, 0.1-scaled for sums and
    dots, int8 in [-128, 128), values in [0, 128) for the histogram; each
    ``offset`` elements past an aligned base."""
    dt = flat_dtype(spec)
    n_args = 2 if spec.family in ("elementwise", "dot-product") else 1
    out = []
    for _ in range(n_args):
        if dt == torch.int8:
            t = torch.randint(-128, 128, shape, generator=run.gen,
                              device="cuda", dtype=torch.int8)
        elif dt == torch.int32:
            t = torch.randint(0, 128, shape, generator=run.gen,
                              device="cuda", dtype=torch.int32)
        else:
            scale = 1.0 if spec.family in ("elementwise", "activation") else 0.1
            t = run.rand(*shape, scale=scale).to(dt)
        if offset:
            buf = torch.empty(t.numel() + offset, dtype=dt, device="cuda")
            bits(buf)[offset:] = bits(t).reshape(-1)
            t = buf[offset:].view(shape)
        out.append(t)
    return tuple(out)


def flat_plain(spec):
    """The plain version of a registered path (m) op."""
    from leetcuda_tpu_torch.ops import activations as act
    from leetcuda_tpu_torch.ops import dot_product as dp
    from leetcuda_tpu_torch.ops import elementwise as ew
    from leetcuda_tpu_torch.ops import histogram as hi
    from leetcuda_tpu_torch.ops import reduce as rd

    if spec.family == "elementwise":
        return ew.add_plain
    if spec.family == "activation":
        f = act.ACTIVATIONS[spec.tags[0]]
        return lambda x: act.activation_plain(f, x)
    if spec.family == "reduce":
        return lambda x: rd.sum_plain(x, spec.fn.acc_dtype)
    if spec.family == "dot-product":
        return dp.dot_plain
    return lambda x: hi.histogram_plain(x, hi.BINS)


def ulp(dtype, a):
    """The spacing of ``dtype``'s values at magnitude ``a``."""
    fi = torch.finfo(dtype)
    if a < fi.tiny:
        return fi.eps * fi.tiny
    return fi.eps * 2.0 ** (math.frexp(a)[1] - 1)


def flat_tol(spec, args):
    """Bit for bit for the add, the histogram and the int8 sum. A float sum
    or dot on ``args`` is held to what f32 accumulation in another order
    and one rounding to the accumulator allow: one ulp of the accumulator
    at the plain result, plus 1e-6 sqrt(n) times its largest term. The
    activations at the registry's tolerance."""
    if spec.family in ("elementwise", "histogram"):
        return EXACT
    if spec.family in ("reduce", "dot-product"):
        want = flat_plain(spec)(*args)
        if not want.dtype.is_floating_point:
            return EXACT
        terms = args[0].float()
        if len(args) > 1:
            terms = terms * args[1].float()
        return dict(atol=ulp(want.dtype, abs(float(want)))
                    + 1e-6 * math.sqrt(terms.numel())
                    * float(terms.abs().max()), rtol=0.0)
    return dict(atol=spec.atol, rtol=spec.rtol)


def _sum_library(x, acc):
    """torch.sum(x, dtype=acc), or x.to(acc).sum() where torch.sum refuses
    x's dtype: (call, its name)."""
    try:
        torch.sum(x, dtype=acc)
        return (lambda: torch.sum(x, dtype=acc)), "torch.sum(x, dtype=acc)"
    except (RuntimeError, TypeError):
        return (lambda: x.to(acc).sum()), "x.to(acc).sum()"


def _flat_case(run, spec, args, check, timed=True, **extra):
    """One registered op of path (m) on ``args``, held against its plain
    version (the add through its bits) and, if ``timed``, timed beside one
    PyTorch call."""
    from leetcuda_tpu_torch.ops import reduce as rd

    kernel, plain, x = FLAT_KERNEL[spec.family], flat_plain(spec), args[0]
    call, want = (lambda: spec.fn(*args)), (lambda: plain(*args))
    if spec.family == "elementwise":
        call, want = (lambda: bits(spec.fn(*args))), (lambda: bits(
            plain(*args)))
    lib = None
    if timed:
        if spec.family == "elementwise":
            lib = lambda: torch.add(*args)  # noqa: E731
        elif spec.family == "activation":
            lib = lambda f=_act_library()[spec.tags[0]]: f(x)  # noqa: E731
        elif spec.family == "reduce":
            lib, extra["library"] = _sum_library(x, spec.fn.acc_dtype)
        elif spec.family == "dot-product":
            xf, yf = x.reshape(-1), args[1].reshape(-1)
            lib = ((lambda: torch.dot(xf, yf)) if x.dtype == torch.float32
                   else (lambda: torch.dot(xf.float(), yf.float())))
        else:
            lib = lambda: torch.bincount(x.reshape(-1),  # noqa: E731
                                         minlength=spec.fn.num_bins)
    nbytes = (spec.bytes(*args) if spec.bytes is not None
              else 4.0 * (x.numel() + spec.fn.num_bins))
    flops = spec.flops(*args) if spec.flops is not None else 0.0
    return run.case(check, kernel, call, want, lib, nbytes, args,
                    tol=flat_tol(spec, args), timed=timed, flops=flops,
                    rung=spec.name, **extra)


def _flat_model_cases(run):
    """The model's shapes: the residual add in bf16 at training's (16384,
    2048) bit for bit beside torch.add; swish and gelu in bf16 at its FFN
    hidden (16384, 5632) beside F.silu and F.gelu(approximate="tanh"); the
    f32 max at (16384, 2048) beside torch.amax; 128 bins over (16384, 2048)
    values and training's (8, 2048) token ids over the vocabulary, beside
    torch.bincount."""
    import torch.nn.functional as F
    from leetcuda_tpu_torch.ops import activations as act
    from leetcuda_tpu_torch.ops import elementwise as ew
    from leetcuda_tpu_torch.ops import histogram as hi
    from leetcuda_tpu_torch.ops import reduce as rd

    M, D = TRAIN_ROWS, MODEL_DIM
    x = run.rand(M, D, dtype=torch.bfloat16)
    y = run.rand(M, D, dtype=torch.bfloat16)
    run.case(f"elementwise_add/bf16 ({M}, {D})", "elementwise_add",
             lambda: bits(ew.elementwise_add_bf16(x, y)),
             lambda: bits(ew.add_plain(x, y)), lambda: torch.add(x, y),
             3.0 * x.numel() * 2, (x, y), tol=EXACT, flops=float(x.numel()),
             S=M, K=D)
    h = run.rand(M, FFN_DIM, dtype=torch.bfloat16)
    for name, fn, lib in (("swish", act.swish, F.silu),
                          ("gelu", act.gelu,
                           lambda t: F.gelu(t, approximate="tanh"))):
        math = act.ACTIVATIONS[name]
        run.case(f"activation/{name} bf16 ({M}, {FFN_DIM})", "activation",
                 lambda: fn(h), lambda: act.activation_plain(math, h),
                 lambda: lib(h), 2.0 * h.numel() * 2, (h,),
                 tol=dict(atol=2e-2, rtol=1e-2), flops=float(h.numel()),
                 S=M, K=FFN_DIM)
    xf = run.rand(M, D)
    run.case(f"block_all_reduce_max/f32 ({M}, {D})", "block_all_reduce_max",
             lambda: rd.block_all_reduce_max_f32(xf),
             lambda: rd.max_plain(xf, torch.float32),
             lambda: torch.amax(xf), 4.0 * xf.numel(), (xf,), tol=EXACT,
             flops=float(xf.numel()), S=M, K=D)
    v = torch.randint(0, hi.BINS, (M, D), generator=run.gen, device="cuda",
                      dtype=torch.int32)
    run.case(f"histogram/{hi.BINS} bins ({M}, {D})", "histogram",
             lambda: hi.histogram(hi.BINS)(v),
             lambda: hi.histogram_plain(v, hi.BINS),
             lambda: torch.bincount(v.reshape(-1), minlength=hi.BINS),
             4.0 * (v.numel() + hi.BINS), (v,), tol=EXACT, S=M, K=D,
             bins=hi.BINS)
    ids = torch.randint(0, VOCAB_BINS, (TRAIN_B, TRAIN_S), generator=run.gen,
                        device="cuda", dtype=torch.int32)
    vocab_hist = hi.make_histogram(VOCAB_BINS)
    run.case(f"histogram/{VOCAB_BINS} bins, ({TRAIN_B}, {TRAIN_S}) token ids",
             "histogram", lambda: vocab_hist(ids),
             lambda: hi.histogram_plain(ids, VOCAB_BINS),
             lambda: torch.bincount(ids.reshape(-1), minlength=VOCAB_BINS),
             4.0 * (ids.numel() + VOCAB_BINS), (ids,), tol=EXACT,
             S=TRAIN_B, K=TRAIN_S, bins=VOCAB_BINS)


def rpn_proposals(gen, n, ramp=False):
    """The ``n`` best-scored of Faster R-CNN's 9 anchors a position
    (``RPN_STRIDE`` over ``RPN_IMAGE``), each corner moved by up to half a
    stride as a regression would move it and clipped to the image: (boxes
    (n, 4) f32, scores (n,)) on the card. Scores are uniform, or with
    ``ramp`` fall along the anchors' raster order (a smooth objectness
    map), so that each box's fate hangs on its neighbour's."""
    (height, width), st = RPN_IMAGE, RPN_STRIDE
    root = torch.tensor([0.5, 1.0, 2.0], device="cuda").sqrt()[:, None]
    sizes = torch.tensor([128.0, 256.0, 512.0], device="cuda")
    w, h = (sizes / root).round().reshape(-1), (sizes * root).round().reshape(-1)
    gy, gx = torch.meshgrid(torch.arange(-(-height // st), device="cuda"),
                            torch.arange(-(-width // st), device="cuda"),
                            indexing="ij")
    x1 = (gx.reshape(-1, 1) * st + st // 2) - (w / 2).floor()
    y1 = (gy.reshape(-1, 1) * st + st // 2) - (h / 2).floor()
    boxes = torch.stack([x1, y1, x1 + w, y1 + h], -1).reshape(-1, 4)
    boxes = boxes + torch.randint(-(st // 2), st // 2 + 1, boxes.shape,
                                  generator=gen, device="cuda")
    boxes = torch.minimum(boxes.clamp(min=0), torch.tensor(
        [width, height, width, height], device="cuda", dtype=boxes.dtype))
    m = boxes.shape[0]
    scores = (1.0 - torch.arange(m, device="cuda") / m if ramp
              else torch.rand(m, generator=gen, device="cuda"))
    top = torch.topk(scores, n).indices
    return boxes[top].float(), scores[top]


def suppression_chain(n):
    """``n`` 128-pixel boxes in a row 16 pixels apart, scores falling along
    it: each overlaps the next by IoU 0.78 and the one after by 0.6, so the
    greedy pass keeps every other box, each decided by the box before."""
    x = torch.arange(n, device="cuda", dtype=torch.float32) * 16
    z = torch.zeros_like(x)
    return (torch.stack([x, z, x + 128, z + 128], 1),
            1.0 - torch.arange(n, device="cuda") / n)


def _nms_cases(run):
    """NMS on the card (no kernel: torch ops and a walk on the host) over
    Faster R-CNN's proposals at 1000 and 6000 boxes, over 6000 with
    ramped scores and over a 6000-box suppression chain, keep-equal to
    nms_ref and its indices in score order; wall time (median of 5,
    synchronised). Returns {input: result}."""
    from leetcuda_tpu_torch.ops import nms as nm

    inputs = {f"rpn {n}": rpn_proposals(run.gen, n) for n in NMS_BOXES}
    inputs[f"rpn {NMS_BOXES[-1]}, ramped scores"] = rpn_proposals(
        run.gen, NMS_BOXES[-1], ramp=True)
    inputs[f"chain {NMS_BOXES[-1]}"] = suppression_chain(NMS_BOXES[-1])
    out = {}
    for what, (boxes, scores) in inputs.items():
        keep = nm.nms(boxes, scores, NMS_THRESHOLD)
        want = nm.nms_ref(boxes.cpu().numpy(), scores.cpu().numpy(),
                          NMS_THRESHOLD)
        if not np.array_equal(keep.cpu().numpy(), want):
            raise AssertionError(f"nms: {what} differs from nms_ref in "
                                 f"{int((keep.cpu().numpy() != want).sum())}")
        idx = nm.nms_indices(boxes, scores, NMS_THRESHOLD).cpu().numpy()
        order = np.argsort(-scores.cpu().numpy(), kind="stable")
        kept = order[want[order]]
        if not (np.array_equal(idx[:len(kept)], kept)
                and (idx[len(kept):] == -1).all()):
            raise AssertionError(f"nms_indices: {what}, wrong indices")
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nm.nms(boxes, scores, NMS_THRESHOLD)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[what] = {"ms": float(np.median(times)), "boxes": len(want),
                     "kept": int(want.sum()), "threshold": NMS_THRESHOLD}
    return out


def flat_shapes(run, res):
    """Path (m), part 2, timed: the model's shapes, then every add and
    activation rung at 4096^2 and every sum and dot rung and both histogram
    rungs at (16384, 2048) in their dtypes; NMS (into ``res``)."""
    from leetcuda_tpu_torch.core.registry import OPS

    _flat_model_cases(run)
    for name, spec in OPS.items():
        if spec.family not in FLAT_FAMILIES:
            continue
        shape = ((FLAT_DIM, FLAT_DIM)
                 if spec.family in ("elementwise", "activation")
                 else (TRAIN_ROWS, MODEL_DIM))
        _flat_case(run, spec, flat_args(run, spec, shape),
                   f"{FLAT_KERNEL[spec.family]}/{name} {shape}",
                   S=shape[0], K=shape[1])
    res["nms"] = _nms_cases(run)


def _hold_nan(check, got, want, tol):
    """NaN exactly where ``want`` has NaN, and elsewhere within ``tol`` (bit
    for bit where it is EXACT)."""
    gn, wn = torch.isnan(got.float()), torch.isnan(want.float())
    if not torch.equal(gn, wn):
        raise AssertionError(f"{check}: NaN at other places than the plain "
                             f"version ({int((gn != wn).sum())})")
    if tol is EXACT:
        if not torch.equal(bits(got[~gn]), bits(want[~wn])):
            raise AssertionError(f"{check}: differs from the plain version")
        return 0.0
    return hold(got[~gn], want[~wn], tol)


def flat_checks(run):
    """Path (m), part 3, untimed: every registered rung and the max at the
    ragged shapes and one element off an aligned base; NaN, infinities and
    signed zeros through the add and every activation; NaN in the f32 sum
    and the max, e4m3's NaN bytes in its sum; an int8 sum that wraps; every
    float sum, the max and every dot twice, bit for bit; histogram values
    outside the bins, at 128, 32000 and 128256 bins (the last past the
    opt-in shared memory: the kernel's device-memory branch). Every call's
    inputs are checked unchanged."""
    from leetcuda_tpu_torch.core.registry import OPS
    from leetcuda_tpu_torch.ops import activations as act
    from leetcuda_tpu_torch.ops import histogram as hi
    from leetcuda_tpu_torch.ops import reduce as rd

    specs = [s for s in OPS.values() if s.family in FLAT_FAMILIES]
    for shape, off in FLAT_RAGGED:
        for spec in specs:
            _flat_case(run, spec, flat_args(run, spec, shape, off),
                       f"{FLAT_KERNEL[spec.family]}/{spec.name} {shape} + "
                       f"{off}", timed=False)
        x = flat_args(run, OPS["block_all_reduce_sum_f32_f32"], shape, off)
        run.case(f"block_all_reduce_max/{shape} + {off}",
                 "block_all_reduce_max",
                 lambda: rd.block_all_reduce_max_f32(*x),
                 lambda: rd.max_plain(*x, torch.float32), None, 0.0, x,
                 tol=EXACT, timed=False)

    sp = torch.tensor(SPECIALS, device="cuda")
    for dt in (torch.float32, torch.float16, torch.bfloat16):
        x = sp[:, None].expand(len(sp), len(sp)).to(dt).contiguous()
        y = sp[None, :].expand(len(sp), len(sp)).to(dt).contiguous()
        for spec in specs:
            if spec.family not in ("elementwise", "activation") or (
                    flat_dtype(spec) != dt):
                continue
            args = (x, y) if spec.family == "elementwise" else (x,)
            before = [t.clone() for t in args]
            got, want = spec.fn(*args), flat_plain(spec)(*args)
            unchanged(spec.name, args, before)
            check = f"{FLAT_KERNEL[spec.family]}/{spec.name} specials"
            run.checks[check] = _hold_nan(check, got, want,
                                          flat_tol(spec, args))
    if not torch.equal(act.hardshrink(x[:1]).float(),
                       torch.zeros_like(x[:1], dtype=torch.float32)):
        raise AssertionError("hardshrink: NaN must map to 0")

    xf = run.rand(700, 4000)
    xf[123, 456] = float("nan")
    for check, fn in (("block_all_reduce_sum", rd.block_all_reduce_sum_f32),
                      ("block_all_reduce_max", rd.block_all_reduce_max_f32)):
        before = xf.clone()
        got = fn(xf)
        unchanged(check, (xf,), (before,))
        if not torch.isnan(got):
            raise AssertionError(f"{check}: a NaN in x must give NaN")
        run.checks[f"{check}/NaN in f32"] = 0.0
    e4 = OPS["block_all_reduce_sum_fp8_e4m3_f16"]
    for byte in (0x7F, 0xFF):
        (x8,) = flat_args(run, e4, (1300, 2500))
        x8.view(torch.uint8)[700, 1234] = byte
        before = x8.clone()
        got = e4.fn(x8)
        unchanged("e4m3 sum", (x8,), (before,))
        if not (torch.isnan(got)
                and torch.isnan(rd.sum_plain(x8, torch.float16))):
            raise AssertionError(f"e4m3 byte {byte:#x} must sum to NaN")
        run.checks[f"block_all_reduce_sum/e4m3 byte {byte:#x}"] = 0.0
    i8 = OPS["block_all_reduce_sum_i8_i32"]
    x127 = torch.full((TRAIN_ROWS, MODEL_DIM), 127, dtype=torch.int8,
                      device="cuda")
    run.case("block_all_reduce_sum/int8 all 127, wrapping",
             "block_all_reduce_sum", lambda: i8.fn(x127), lambda: rd.sum_plain(x127, torch.int32),
             None, 0.0, (x127,), tol=EXACT, timed=False)
    if int(i8.fn(x127)) != (127 * x127.numel() + 2 ** 31) % 2 ** 32 - 2 ** 31:
        raise AssertionError("the int8 sum must wrap mod 2^32")

    shape = (TRAIN_ROWS, MODEL_DIM)
    twice = [(s.name, s.fn, flat_args(run, s, shape)) for s in specs
             if s.family in ("reduce", "dot-product")
             and flat_dtype(s) != torch.int8]
    twice.append(("block_all_reduce_max_f32", rd.block_all_reduce_max_f32,
                  (run.rand(*shape),)))
    for name, fn, args in twice:
        a, b = fn(*args), fn(*args)
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{name}: two runs differ in their bits")
        run.checks[f"{name} twice, bit for bit"] = 0.0

    for bins, fns in ((hi.BINS, [s.fn for s in specs
                                  if s.family == "histogram"]),
                      *((b, [hi.make_histogram(b, vec=1),
                             hi.make_histogram(b)])
                        for b in (VOCAB_BINS, LARGE_VOCAB_BINS))):
        v = torch.randint(0, bins, (700, 4000), generator=run.gen,
                          device="cuda", dtype=torch.int32)
        v.view(-1)[:8] = torch.tensor([-3, -1, bins, bins + 50] * 2,
                                      device="cuda")
        for fn in fns:
            run.case(f"histogram/{bins} bins, vec {fn.vec}, out of range",
                     "histogram", lambda: fn(v),
                     lambda: hi.histogram_plain(v, bins), None, 0.0, (v,),
                     tol=EXACT, timed=False)
            if int(fn(v).sum()) != v.numel() - 8:
                raise AssertionError("histogram: out-of-range values must "
                                     "be dropped")


def flat_path():
    """Path (m): the op corpus's add, activations, reductions, dot product
    and histogram on the card, in three parts, each driven with the launch
    counts zeroed just before it and read just after. Returns (rows for the
    kernels line, the path's report)."""
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    run = RowRun(flush, src=FLAT_SRC)
    res = {"launches": {}}
    t0 = time.perf_counter()
    for part, fn in (("m1", lambda: registry_sweep(FLAT_FAMILIES, 136)),
                     ("m2", lambda: flat_shapes(run, res)),
                     ("m3", lambda: flat_checks(run))):
        out, counts, _ = drive(part, fn)
        if part == "m1":
            res["registry_max_abs_err"] = out
        res[f"launches_{part}"] = counts
        for k, v in counts.items():
            res["launches"][k] = res["launches"].get(k, 0) + v
    res.update(untimed_checks=run.checks, seconds=time.perf_counter() - t0)
    return run.rec.rows, res


def print_flat(rows, res):
    print(f"path (m) add, activations, reductions, dot, histogram: "
          f"{len(res['registry_max_abs_err'])} registered ops held at their "
          f"registry tolerances; {len(res['untimed_checks'])} untimed checks;"
          f" {len(rows)} timed cases in {res['seconds']:.1f} s", flush=True)
    for r in rows.values():
        lib = ("library none" if r["library_ms"] is None
               else f"library {r['library_ms']:.4f} ms")
        print(f"  {r['check']}: max_abs_err {r['max_abs_err']:.3g} kernel "
              f"{r['ms']:.4f} ms ({r['gbytes_s']:.0f} GB/s) plain "
              f"{r['plain_ms']:.4f} ms {lib} bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    for what, r in res["nms"].items():
        print(f"  nms {what} ({r['boxes']} boxes, threshold "
              f"{r['threshold']}): {r['kept']} kept, as nms_ref; "
              f"{r['ms']:.4f} ms a call (wall, no kernel)")
    worst = max(res["untimed_checks"].values())
    print(f"  untimed checks: {len(res['untimed_checks'])}, worst max abs "
          f"error {worst:.3g}")
    print(f"  launches: {res['launches']}")


# --- path (n): MoE serving ----------------------------------------------------

GMM_SRC = "leetcuda_tpu_torch/csrc/gmm.cu"
GMM_REPLACES = "leetcuda_tpu/gemm/grouped.py:83"
GMM_TOL = dict(atol=2e-2, rtol=2e-2)  # the registry's (gemm/grouped.py)
# Path (n) serves Qwen3-30B-A3B (models/llama.py qwen3_30b_a3b_config) at
# its published width and depth, random bf16 weights from MOE_SEED: eight
# requests with prompts of 16..1000 tokens in one ragged admission (padded
# to 1024), a lone 100-token request, then ``generate`` at B=8, S=128; 32
# new tokens each.
MOE_PLENS = np.linspace(16, 1000, 8).astype(int)
MOE_LONE, MOE_NEW, MOE_GEN_S, MOE_SEED = 100, 32, 128, 4


def gmm_library(lhs, rhs, tile_group, bm):
    """``torch._grouped_mm`` over the same groups, the yardstick the port
    never calls: (a callable, "") or (None, why there is none). Its groups
    are the runs of ``tile_group``, which must be in expert order; the
    offsets are the runs' ends."""
    if not hasattr(torch, "_grouped_mm"):
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    if lhs.dtype != torch.bfloat16:
        return None, "torch._grouped_mm takes bf16"
    tg_, G = tile_group.long(), rhs.shape[0]
    if bool((tg_[1:] < tg_[:-1]).any()) or not 0 <= int(tg_.min()) <= int(
            tg_.max()) < G:
        return None, "row tiles not in expert order"
    offs = (torch.cumsum(torch.bincount(tg_, minlength=G), 0) * bm).to(
        torch.int32)
    refused = []
    # row-major panels first, then the same values column-major
    for b in (rhs, rhs.transpose(1, 2).contiguous().transpose(1, 2)):
        def fn(b=b):
            return torch._grouped_mm(lhs, b, offs=offs)
        try:
            fn()
            torch.cuda.synchronize()
            return fn, ""
        except RuntimeError as e:
            refused.append(str(e).splitlines()[0][:160])
    return None, "torch._grouped_mm refused: " + " | ".join(refused)


def check_gmm(rec, flush, moe, cfg):
    """Phase 3 of path (n): the grouped matmul against its plain version at
    the registry's 2e-2, timed beside it and torch._grouped_mm, on layer
    0's experts (``moe``): the gate and down products of a decode step
    (B=8 tokens routed by layer 0's router, unit-rms hidden states) and of
    an 8 x 1024 prefill; every copy to one expert; 24 experts of 128
    non-empty; ragged N (1000: a partial tile, 203: the tile route); f32
    (the tile route) and f16. Each case runs the route that
    gemm/grouped.py ``gmm_route`` picks and is recorded under that route's
    counter (``gmm``: the TMA + wgmma kernel; ``gmm_tile``: the old tiles);
    at (n)'s four shapes the two routes are also timed in turn
    (``interleaved_ms``). Then, untimed, on both routes: row tiles of 64
    and 256 rows with an expert id past either end (NaN rows, as the plain
    version), and K and N that are not multiples of 64 (TMA's zero fill
    inside one expert's panel). Each row's bound counts the operations of
    the live rows (the routed copies) and the bytes of lhs, out and each
    distinct expert panel once; the bound of all rows beside it. The
    wgmma kernels' SASS must hold HGMMA and UTMALDG and no HMMA. Returns
    the untimed checks' errors."""
    import torch.nn.functional as F

    from leetcuda_tpu_torch.gemm import grouped as gg
    from leetcuda_tpu_torch.models.moe import dropless_dispatch

    bm, D, Fm = 128, cfg.dim, cfg.moe.ffn_dim
    gmm = gg.make_gmm(block=(bm, 2048, 2048))

    def case(check, lhs, rhs, tile_group, live_rows, tiles_live=None,
             routes=False):
        T, K = lhs.shape
        G, _, N = rhs.shape
        plan = gg.gmm_plan(T, K, N, bm, lhs.dtype)
        got = gmm(lhs, rhs, tile_group)
        want = gg.gmm_plain(lhs, rhs, tile_group, bm)
        lib, why = gmm_library(lhs, rhs, tile_group, bm)
        panels = int(torch.unique(tile_group).numel())
        nbytes = (lhs.element_size() * (T * K + T * N + panels * K * N)
                  + 4.0 * tile_group.numel())
        rate = PEAK_RATE[lhs.dtype]
        name = "gmm" if plan["route"] == "wgmma" else "gmm_tile"
        rec.record(f"gmm/{check}", name, GMM_SRC, GMM_REPLACES, got, want,
                   time_ms(lambda: gmm(lhs, rhs, tile_group), flush),
                   time_ms(lambda: gg.gmm_plain(lhs, rhs, tile_group, bm),
                           flush, iters=5),
                   None if lib is None else time_ms(lib, flush),
                   2.0 * live_rows * K * N, nbytes, tol=GMM_TOL, rate=rate)
        every = bound(2.0 * T * K * N, nbytes, rate)
        row = rec.rows[f"gmm/{check}"]
        row.update(T=T, K=K, N=N, G=G, live_rows=live_rows, panels=panels,
                   tiles=T // bm, tiles_live=tiles_live,
                   dtype=str(lhs.dtype).split(".")[-1],
                   bound_all_rows_ms=every[0] * 1e3,
                   bound_all_rows_by=every[1], plan=plan,
                   library="torch._grouped_mm" if lib else why)
        if lib is not None:
            row["library_max_abs_err"] = float(
                (lib().float() - want.float()).abs().max())
        if routes:  # the wgmma route beside the tile route, in turn
            with uncounted():
                old = gg._launch(lhs, rhs, tile_group, bm, route="tile")
            row["tile_route_max_abs_err"] = hold(old, want, GMM_TOL)
            row["routes_ms"] = interleaved_ms({
                "wgmma": lambda: gmm(lhs, rhs, tile_group),
                "tile": lambda: gg._launch(lhs, rhs, tile_group, bm,
                                           route="tile")}, flush)
        return got

    def by_sizes(sizes):
        sizes = torch.tensor(sizes, device=rec.dev)
        return gg.tile_groups_from_sizes(sizes, bm, int(sizes.sum()) // bm)

    for label, T in (("decode B=8", 8), ("prefill 8x1024", 8 * 1024)):
        buf, tiles, pos, _, _ = dropless_dispatch(rec.randn(T, D),
                                                  moe, cfg.moe, bm)
        live = T * cfg.moe.topk
        n_live = int(torch.unique(pos // bm).numel())
        gate = case(f"{label} gate K={D} N={Fm}", buf, moe["w_gate"], tiles,
                    live, n_live, routes=True)
        up = gmm(buf, moe["w_up"], tiles)
        h = (F.silu(gate.float()) * up.float()).to(torch.bfloat16)
        case(f"{label} down K={Fm} N={D}", h, moe["w_down"], tiles, live,
             n_live, routes=True)
    case(f"every copy to expert 7, 8192 rows, K={D} N={Fm}",
         rec.randn(8192, D), moe["w_gate"],
         torch.full((64,), 7, dtype=torch.int32, device=rec.dev), 8192)
    sizes = np.zeros(cfg.moe.n_experts, np.int64)
    picked = rec.rng.choice(cfg.moe.n_experts, 24, replace=False)
    sizes[picked] = bm * rec.rng.integers(1, 4, 24)
    case(f"24 of 128 experts, {int(sizes.sum())} rows, K={D} N={Fm}",
         rec.randn(int(sizes.sum()), D), moe["w_gate"],
         by_sizes(sizes.tolist()), int(sizes.sum()))
    for K, N in ((D, 1000), (Fm, 203)):
        case(f"ragged N, 8 experts, K={K} N={N}", rec.randn(2048, K),
             rec.randn(8, K, N, scale=K ** -0.5),
             by_sizes([256, 0, 512, 128, 384, 0, 640, 128]), 2048)
    for dt in (torch.float32, torch.float16):
        case(f"{str(dt).split('.')[-1]}, JAX's test shapes, K=256 N=384",
             rec.randn(768, 256).to(dt), rec.randn(3, 256, 384).to(dt),
             by_sizes([256, 128, 384]), 768)

    untimed = {}
    for K, N in ((256, 256), (776, 264)):  # 776 and 264: 8 past 64s
        lhs = rec.randn(512, K)
        rhs = rec.randn(4, K, N, scale=K ** -0.5)
        for rows, tiles in ((64, [0, 3, 4, 1, -1, 2, 2, 3]), (256, [3, 1]),
                            (128, [2, 0, 5, 3])):
            tiles = torch.tensor(tiles, dtype=torch.int32, device=rec.dev)
            want = gg.gmm_plain(lhs, rhs, tiles, rows)
            bad = ((tiles < 0) | (tiles >= 4)).repeat_interleave(rows)
            for route in ("wgmma", "tile"):
                with uncounted():
                    got = gg._launch(lhs, rhs, tiles, rows, route=route)
                if not (torch.isnan(got).all(dim=1) == bad).all() or bool(
                        torch.isnan(got[~bad]).any()):
                    raise AssertionError(
                        f"gmm {route} route, row tiles of {rows}, K={K} "
                        f"N={N}: NaN rows are not those of the out-of-range "
                        "experts")
                untimed[f"{route}: row tiles of {rows}, K={K} N={N}"] = hold(
                    got[~bad], want[~bad], GMM_TOL)
    rec.rows[next(k for k in rec.rows if k.startswith("gmm/"))]["sass"] = (
        resident_sass("gmm", "gmm_sm90"))
    return untimed


@contextlib.contextmanager
def model_calls(calls):
    """Count the engine's calls of forward, forward_ragged, decode_step and
    decode_chunk into ``calls`` (engine/engine.py looks them up at call
    time, decode_chunk in engine/speculative.py)."""
    from leetcuda_tpu_torch.engine import engine as em
    from leetcuda_tpu_torch.engine import speculative as sp

    saved = {(m, n): getattr(m, n) for m, n in (
        (em, "forward"), (em, "forward_ragged"), (em, "decode_step"),
        (sp, "decode_chunk"))}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        return wrapped

    for (m, name), fn in saved.items():
        setattr(m, name, counting(name, fn))
    try:
        yield calls
    finally:
        for (m, name), fn in saved.items():
            setattr(m, name, fn)


def moe_path(dev="cuda"):
    """Path (n): Qwen3-30B-A3B (48 layers, 128 experts, top-8, bf16,
    dropless), built on the card from a seed; phase 3's gmm checks on its
    layer 0; the Engine's eight requests and the lone one, then
    ``generate``, with the launch counts zeroed just before and read just
    after, and exactly 3 gmm launches per layer per forward, ragged forward
    and decode step; every served token teacher-forced against a solo B=1
    replay (phase 5); one B=8 decode step at context 1024 profiled (phase
    6). Run first, on an empty card: the weights take 60.5 GB. Returns
    (rows for the kernels line, the path's report). ``dev``: "cpu" for a
    rehearsal at a cut size."""
    from leetcuda_tpu_torch.engine import generate
    from leetcuda_tpu_torch.models.llama import (init_params,
                                                 qwen3_30b_a3b_config)

    cfg = qwen3_30b_a3b_config()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(MOE_SEED),
                         cfg, device=dev)
    sync(params["embed"].device)
    moe = cfg.moe
    expert_bytes = sum(params["layers"][0]["moe"][k].nbytes
                       for k in ("w_gate", "w_up", "w_down"))
    res = {"model": "Qwen3-30B-A3B", "init_s": time.perf_counter() - t0,
           "weight_bytes": param_bytes(params),
           "config": {k: (str(v) if isinstance(v, torch.dtype) else v)
                      for k, v in dataclasses.asdict(cfg).items()}}
    # a B=8 step reads at least the non-expert weights and, in every layer,
    # the top-k experts of one token: the tok/s ceiling
    step_bytes = (res["weight_bytes"] - cfg.n_layers * expert_bytes
                  * (1 - moe.topk / moe.n_experts))
    res["tok_s_ceiling"] = 8 / (step_bytes / HBM_BYTES_PER_S)

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rec = Recorder(dev)
    res["gmm_untimed"] = check_gmm(rec, flush, params["layers"][0]["moe"],
                                   cfg)
    del flush
    res["phase3_s"] = time.perf_counter() - t0 - res["init_s"]

    rng = np.random.default_rng(MOE_SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in MOE_PLENS]
    lone = rng.integers(0, cfg.vocab_size, MOE_LONE).tolist()
    gprompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (8, MOE_GEN_S)).astype(np.int32)).to(dev)
    generate(params, cfg, gprompts[:1, :16], 2, device=dev)  # warm-up
    calls = {}

    def serve():
        with model_calls(calls):
            eng, served = serve_engine(params, cfg, prompts, lone,
                                       max_new=MOE_NEW, max_seq=2048,
                                       bucket=128)
            gen_, gtoks = serve_generate(params, cfg, gprompts, MOE_NEW)
        return {**eng, **gen_}, served, gtoks

    (out, served, gtoks), counts, peak = drive("n", serve)
    res.update(out, launches=counts, model_calls=calls,
               peak_extra_bytes=peak,
               peak_bytes=torch.cuda.max_memory_allocated())
    want = 3 * cfg.n_layers * sum(calls.values())
    if counts.get("gmm", 0) != want or counts.get("gmm_tile", 0):
        raise AssertionError(f"path n: {counts.get('gmm', 0)} gmm launches "
                             f"on the wgmma route and "
                             f"{counts.get('gmm_tile', 0)} on the tile route "
                             f"for {calls}, not 3 per layer per call, all "
                             f"wgmma ({want})")
    for what in ("engine_tok_s", "generate_tok_s"):
        if res[what] > res["tok_s_ceiling"]:
            raise AssertionError(f"path n: {what} {res[what]:.0f} exceeds "
                                 f"its ceiling {res['tok_s_ceiling']:.0f}")

    # phase 5: the ragged admission's requests and generate's streams
    # replay through a B=1 forward, the lone one (which the Engine
    # prefilled through forward) token by token through decode_step
    t5 = time.perf_counter()
    gaps = {f"engine/{i}": replay_gap(params, cfg, p, toks, None)
            for i, (p, toks) in enumerate(zip(prompts, served))}
    gaps["lone"] = teacher_forced_gap(params, cfg, lone, served[-1])
    for b, toks in enumerate(gtoks.tolist()):
        gaps[f"generate/{b}"] = replay_gap(params, cfg, gprompts[b].tolist(),
                                           toks, None)
    res["teacher_forced"] = {"tol": LOGIT_TOL, "worst": max(gaps.values()),
                             "gaps": gaps,
                             "seconds": time.perf_counter() - t5}
    if res["teacher_forced"]["worst"] > LOGIT_TOL:
        raise AssertionError(f"path n: served tokens off the solo replay: "
                             f"{gaps}")

    # phase 6: one B=8 decode step at context 1024
    res["profile"] = profile_decode(params, cfg, batch=8, context=1024,
                                    classes={"gmm": ("gmm_sm90",
                                                     "gmm_kernel")})
    return rec.rows, res


def print_moe(rows, res):
    c = res["config"]
    for r in rows.values():
        lib = (f"library {r['library_ms']:.4f} ms "
               f"(max abs diff {r['library_max_abs_err']:.3g})"
               if r["library_ms"] is not None else
               f"library none ({r['library']})")
        live = ("" if r["tiles_live"] is None else
                f", {r['tiles_live']} of {r['tiles']} tiles live")
        p = r["plan"]
        route = (f"{p['route']} route"
                 + (f" {p['block_m']} x {p['block_n']}, {p['grid']} CTAs "
                    f"over {p['units']} tiles" if p["route"] == "wgmma"
                    else ""))
        if "routes_ms" in r:
            route += (f"; in turn: wgmma {r['routes_ms']['wgmma']:.4f} ms, "
                      f"tile {r['routes_ms']['tile']:.4f} ms (max abs "
                      f"{r['tile_route_max_abs_err']:.3g})")
        print(f"kernel {r['check']} [{route}]: max_abs_err "
              f"{r['max_abs_err']:.3g} kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms {lib} bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['live_rows']} live rows; all {r['T']} "
              f"rows {r['bound_all_rows_ms']:.4f} ms, "
              f"{r['bound_all_rows_by']}){live}", flush=True)
    print(f"  gmm untimed: {res['gmm_untimed']}")
    print(f"  gmm wgmma SASS: {next(iter(rows.values()))['sass']}")
    print(f"path (n) {res['model']} ({c['n_layers']} layers, "
          f"{c['n_experts']} experts, top-{c['expert_topk']}, dropless, "
          f"bf16, random weights built in {res['init_s']:.1f} s): engine 8 "
          f"requests (prompts {MOE_PLENS.tolist()}) x {MOE_NEW} tokens in "
          f"{res['engine_batch_s']:.3f} s = {res['engine_tok_s']:.1f} tok/s "
          f"(admission {res['engine_admit_s']:.3f} s); lone "
          f"{MOE_LONE}-token request {res['lone_request_s']:.3f} s; generate "
          f"B=8 S={MOE_GEN_S} x {MOE_NEW}: {res['generate_s']:.3f} s = "
          f"{res['generate_tok_s']:.1f} tok/s; ceiling "
          f"{res['tok_s_ceiling']:.0f} tok/s; params "
          f"{res['weight_bytes'] / 2**30:.2f} GiB, peak device memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"  model calls {res['model_calls']}; launches: {res['launches']}")
    tf = res["teacher_forced"]
    print(f"  teacher-forced: worst gap {tf['worst']:.4f} (tol {tf['tol']}) "
          f"over {len(tf['gaps'])} streams in {tf['seconds']:.1f} s")
    prof = res["profile"]
    print_profile("(n) Qwen3-30B-A3B, dropless experts", prof)
    gmm_ms = prof["device_ms_by_class"].get("gmm", 0.0)
    if prof["device_ms_per_step"]:
        print(f"  gmm {gmm_ms:.3f} ms of {prof['device_ms_per_step']:.3f} "
              f"device ms a step "
              f"({gmm_ms / prof['device_ms_per_step']:.3f})", flush=True)


# Path (o) serves Gemma-2-27B (models/llama.py gemma2_27b_config) at its
# published width and depth, random bf16 weights from GEMMA_SEED. The paged
# Engine (pages of PAGE, 4 slots of 6144 positions, chunked prefill of 512
# prompt tokens a tick, so that no admission holds more than 512 rows of
# f32 logits over the 256000-token vocabulary) serves prompts of 5120
# tokens (past the 4096-token window at admission), 4000 (crossing it while
# decoding), 1024 and 300, 128 new tokens each, then a lone 700-token
# request; a contiguous Engine admits 1024 and 300 tokens in one ragged
# batch; ``generate`` runs at B=4 over 256-token prompts, 64 new tokens.
GEMMA_SEED = 5
GEMMA_PLENS, GEMMA_NEW = (5120, 4000, 1024, 300), 128
GEMMA_SLOTS, GEMMA_MAX_SEQ, GEMMA_CHUNK, GEMMA_BUCKET = 4, 6144, 512, 128
GEMMA_LONE, GEMMA_LONE_NEW = 700, 32
GEMMA_RAGGED, GEMMA_RAGGED_NEW = (1024, 300), 16
GEMMA_GEN_B, GEMMA_GEN_S, GEMMA_GEN_NEW = 4, 256, 64
# served at w = 0 (see gemma_path); at the drawn w = 1 the same serving is
# held on the first GEMMA_WITNESS_LAYERS layers (depth_witness)
GEMMA_WITNESS_LAYERS = 4
# phase 3 of path (o): the flash forward at N=8192 (both layer kinds) and
# with a window of 1000 at 2048; the ragged forward at lengths 6144 / 4500;
# decode lengths on both sides of the window (6000 sees 1904.., 4097 sees
# 1.., 4096 all of its keys), NaN past every length; chunk bases whose
# T=512 rows cross the window's edge (3700) or sit past it
GEMMA_FLASH_N, GEMMA_SMALL_BAND = 8192, (2048, 1000)
GEMMA_RAGGED_LENS = np.array([6144, 4500], np.int32)
GEMMA_DECODE_LENS = np.array([6000, 4097, 4096, 1000], np.int32)
GEMMA_CHUNK_BASES = np.array([3700, 5000], np.int32)
# the windowed forward at (1, 32, 16384, 128) does 0.44 of the causal one's
# key tiles; its time must stay under BAND_SKIP_MAX of the causal time
BAND_SKIP_N, BAND_SKIP_MAX = 16384, 0.6
# every attention kernel's launch counter: one launch per layer per call
LSE_COUNTERS = ("flash_attention_lse", "decode_attention_lse",
                "decode_attention_quantized_lse", "paged_attention_lse",
                "paged_attention_quantized_lse", "chunk_attention_lse",
                "chunk_attention_quantized_lse", "paged_chunk_attention_lse",
                "paged_chunk_attention_quantized_lse")
ATTN_COUNTERS = ("flash_attention", "flash_attention_ragged",
                 "decode_attention", "decode_attention_quantized",
                 "paged_attention", "paged_attention_quantized",
                 "chunk_attention", "chunk_attention_quantized",
                 "paged_chunk_attention",
                 "paged_chunk_attention_quantized") + LSE_COUNTERS


def band_tiles(N, window, tile=64):
    """64 x 64 tiles the flash forward visits over N causal rows: q tile i
    walks key tiles from the band of its first row to the diagonal."""
    q0 = np.arange(0, N, tile)
    first = (np.maximum(q0 - window + 1, 0) // tile if window
             else np.zeros_like(q0))
    return int((q0 // tile - first + 1).sum())


def check_attn_options(rec, flush, cfg, tag="o", wrong_scale=None):
    """Phase 3 of path (o) and, at head dim 256, of path (r) (``tag``): the
    window and softcap of kernels 1-9 at the layer-0 shapes of ``cfg``
    (Gemma-2-27B: 32 / 16 heads of 128, scale 144^-0.5; Gemma-2-9B: 16 / 8
    heads of 256, scale 256^-0.5), a
    local layer (window 4096, cap 50) and a global one (cap 50), each held
    against its plain version at KERNEL_TOL and timed beside it and SDPA
    with the band as an explicit boolean mask (SDPA has no softcap): the
    flash forward at (1, H, 8192, D) with and without its lse, and with
    a window of 1000 (inside a key tile) at 2048; the ragged forward at
    B=2, N=6144, lengths 6144 / 4500 with NaN past them; the band skip at
    (1, H, 16384, D), windowed against causal; decode over bf16, int8
    and e4m3 caches and paged pools of 128 at B=4, S=6144, lengths
    GEMMA_DECODE_LENS, NaN past every length; the chunk kernel with the
    cap at T=512 over bases GEMMA_CHUNK_BASES (contiguous bf16 and e4m3,
    paged bf16 both layers, paged e4m3). q is drawn at CAP_Q_SCALE, so
    that the cap bends the scores, and beside every check the kernel
    uncapped and at cap / log2(e) must fail it (``Recorder.cap_controls``),
    and with ``wrong_scale`` also the kernel at that scale. Decode and paged
    go to the split-KV kernel (csrc/decode_attn.cu) at head dim 128 and
    256. Each bound counts the band's work. Returns the band skip's times."""
    from leetcuda_tpu_torch.attention import decode as dec
    from leetcuda_tpu_torch.attention import flash as fl
    from leetcuda_tpu_torch.attention import paged as pg
    from leetcuda_tpu_torch.core.runtime import as_bytes
    from leetcuda_tpu_torch.models.llama import _quantize_token_kv

    dev, bf = rec.dev, torch.bfloat16
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    W, cap, scale = cfg.sliding_window, cfg.attn_softcap, cfg.query_scale
    layers = {"local": dict(window=W, softcap=cap),
              "global": dict(softcap=cap)}
    lib_note = "SDPA, explicit band mask, no softcap"

    def note(check, **kw):
        rec.rows[check].update(library=lib_note, **kw)

    # the flash forward, (1, 32, 8192, 128), and a window of 1000 at 2048
    n_small, w_small = GEMMA_SMALL_BAND
    for N, cases in ((GEMMA_FLASH_N, layers),
                     (n_small, {f"window {w_small}": dict(window=w_small,
                                                          softcap=cap)})):
        q = rec.randn(1, H, N, D, scale=CAP_Q_SCALE)
        k, v = rec.randn(1, Hkv, N, D), rec.randn(1, Hkv, N, D)
        for layer, opt in cases.items():
            w = opt.get("window")
            w_out, w_lse = fl.flash_attention_plain(
                q, k, v, causal=True, sm_scale=scale, with_lse=True, **opt)
            plain_ms = time_ms(lambda: fl.flash_attention_plain(
                q, k, v, causal=True, sm_scale=scale, with_lse=True, **opt),
                flush, iters=2, warmup=1)
            mask = fl.band_mask(N, N, dev, True, w)
            lib_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask,
                                          scale=scale), flush)
            # the nearest flash call of the library: SDPA causal, no cap
            causal_ms = (time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                              scale=scale), flush)
                         if N == GEMMA_FLASH_N else None)
            pairs = band_pairs(N, w)
            for with_lse in (False, True):
                def kern(c=cap, s=scale, with_lse=with_lse):
                    return fl.flash_attention(q, k, v, causal=True,
                                              sm_scale=s, window=w,
                                              softcap=c, with_lse=with_lse)

                def part(c, s=scale, with_lse=with_lse):
                    return kern(c, s)[1] if with_lse else kern(c, s)
                got, want, name = kern(), w_out, "flash_attention"
                if with_lse:
                    hold(got[0], w_out)
                    got, want, name = got[1], w_lse, "flash_attention_lse"
                check = f"({tag}) {name}/{layer} N={N}"
                rec.record(check, name, FLASH_SRC,
                           "leetcuda_tpu/attention/flash.py:259", got, want,
                           time_ms(kern, flush), plain_ms, lib_ms,
                           4.0 * H * D * pairs,
                           2.0 * (2 * H * N * D + 2 * Hkv * N * D)
                           + (4.0 * H * N if with_lse else 0.0))
                note(check, window=w, softcap=cap, N=N,
                     sdpa_causal_ms=causal_ms)
                rec.cap_controls(check, part, want, cap, wrong_scale)
            del w_out, w_lse, mask

    # the ragged forward, a local layer, NaN past the lengths
    lens_np = GEMMA_RAGGED_LENS
    B, N = len(lens_np), int(lens_np.max())
    lengths = torch.from_numpy(lens_np).to(dev)
    q = rec.randn(B, H, N, D, scale=CAP_Q_SCALE)
    k, v = rec.randn(B, Hkv, N, D), rec.randn(B, Hkv, N, D)
    for b, n in enumerate(lens_np):
        k[b, :, n:], v[b, :, n:] = float("nan"), float("nan")
    opt = layers["local"]
    w_out, w_lse = fl.flash_attention_plain(q, k, v, causal=True,
                                            sm_scale=scale, lengths=lengths,
                                            with_lse=True, **opt)
    plain_ms = time_ms(lambda: fl.flash_attention_plain(
        q, k, v, causal=True, sm_scale=scale, lengths=lengths, with_lse=True,
        **opt), flush, iters=2, warmup=1)
    cols = torch.arange(N, device=dev)
    mask = (fl.band_mask(N, N, dev, True, W)[None]
            & (cols[None, None, :] < lengths[:, None, None]))[:, None]
    kd, vd = torch.nan_to_num(k), torch.nan_to_num(v)
    lib_ms = time_ms(lambda: sdpa(q, kd, vd, attn_mask=mask, scale=scale),
                     flush)
    del kd, vd, mask
    n_valid = int(lens_np.sum())
    pairs = sum(band_pairs(int(n), W) for n in lens_np)
    for with_lse in (False, True):
        def kern(c=cap, s=scale, with_lse=with_lse):
            return fl.flash_attention_ragged(q, k, v, lengths, sm_scale=s,
                                             window=W, softcap=c,
                                             with_lse=with_lse)

        def part(c, s=scale, with_lse=with_lse):
            return kern(c, s)[1] if with_lse else kern(c, s)
        got, want, name = kern(), w_out, "flash_attention_ragged"
        if with_lse:
            hold(got[0], w_out)
            got, want, name = got[1], w_lse, "flash_attention_lse"
        if not torch.isfinite(got).all():
            raise AssertionError("ragged flash let NaN past a length through")
        check = f"({tag}) {name}/ragged local B={B} N={N}"
        rec.record(check, name, FLASH_SRC,
                   "leetcuda_tpu/attention/flash.py:367", got, want,
                   time_ms(kern, flush), plain_ms, lib_ms,
                   4.0 * H * D * pairs,
                   2.0 * (H * n_valid * D + 2 * Hkv * n_valid * D
                          + B * H * N * D)
                   + (4.0 * B * H * N if with_lse else 0.0))
        note(check, window=W, softcap=cap, lengths=lens_np.tolist())
        rec.cap_controls(check, part, want, cap, wrong_scale)
    del w_out, w_lse, q, k, v

    # the band skip: the windowed forward against the causal one
    N = BAND_SKIP_N
    q, k, v = rec.randn(1, H, N, D), rec.randn(1, Hkv, N, D), rec.randn(
        1, Hkv, N, D)
    t = {layer: time_ms(lambda opt=opt: fl.flash_attention(
        q, k, v, causal=True, sm_scale=scale, **opt), flush)
        for layer, opt in layers.items()}
    skip = {"N": N, "H": H, "D": D, "window": W, "local_ms": t["local"],
            "global_ms": t["global"], "ratio": t["local"] / t["global"],
            "tile_ratio": band_tiles(N, W) / band_tiles(N, None),
            "max_ratio": BAND_SKIP_MAX}
    if skip["ratio"] >= BAND_SKIP_MAX:
        raise AssertionError(f"band skip: the windowed forward takes "
                             f"{skip['ratio']:.3f} of the causal one's time "
                             f"(tiles {skip['tile_ratio']:.3f})")
    del q, k, v

    # decode over a contiguous cache: bf16 both layers, int8 and e4m3 local
    B, S = len(GEMMA_DECODE_LENS), GEMMA_MAX_SEQ
    lens_np = GEMMA_DECODE_LENS
    lengths = torch.from_numpy(lens_np).to(dev)
    cols = torch.arange(S, device=dev)[None, :]
    past = (cols >= lengths[:, None])[:, None, :].expand(B, Hkv, S)
    q = rec.randn(B, H, D, scale=CAP_Q_SCALE)

    def seen(w):
        """(B, S) positions each row attends, and their count."""
        m = cols < lengths[:, None]
        if w:
            m = m & (cols >= lengths[:, None] - w)
        return m, int(np.minimum(lens_np, w or S).sum())

    kc, vc = rec.randn(B, Hkv, S, D), rec.randn(B, Hkv, S, D)
    kc[past], vc[past] = float("nan"), float("nan")
    kd, vd = torch.nan_to_num(kc), torch.nan_to_num(vc)
    for layer, opt in layers.items():
        m, n_att = seen(opt.get("window"))
        args = (q, kc, vc, lengths)
        got = dec.decode_attention(*args, sm_scale=scale, **opt)
        if not torch.isfinite(got).all():
            raise AssertionError("decode kernel let NaN padding through")
        check = f"({tag}) decode_attention/{layer} B={B} S={S}"
        want = dec.decode_attention_plain(*args, sm_scale=scale, **opt)
        rec.record(check, "decode_attention", DECODE_SRC,
                   "leetcuda_tpu/attention/decode.py:223", got, want,
                   time_ms(lambda: dec.decode_attention(
                       *args, sm_scale=scale, **opt), flush),
                   time_ms(lambda: dec.decode_attention_plain(
                       *args, sm_scale=scale, **opt), flush, iters=5),
                   time_ms(lambda: sdpa(q[:, :, None], kd, vd,
                                        attn_mask=m[:, None, None, :],
                                        scale=scale), flush),
                   4.0 * H * D * n_att,
                   2.0 * (2 * Hkv * n_att * D + 2 * B * H * D) + 4 * B)
        note(check, lengths=lens_np.tolist(), **opt)
        rec.cap_controls(check, lambda c, s=scale, opt=opt:
                         dec.decode_attention(*args, sm_scale=s,
                                              **{**opt, "softcap": c}),
                         want, cap, wrong_scale)
    opt = layers["local"]
    m, n_att = seen(W)
    quant = {}
    for fmt, qdt in (("fp8", torch.float8_e4m3fn), ("int8", torch.int8)):
        kq, ks = _quantize_token_kv(rec.randn(B, Hkv, S, D), qdt)
        vq, vs = _quantize_token_kv(rec.randn(B, Hkv, S, D), qdt)
        kdq = (kq.float() * ks[..., None]).to(bf)
        vdq = (vq.float() * vs[..., None]).to(bf)
        ks[past], vs[past] = float("nan"), float("nan")
        kbyte, vbyte = (0x7F, 0xFF) if fmt == "fp8" else (0, 0)
        as_bytes(kq)[past], as_bytes(vq)[past] = kbyte, vbyte
        quant[fmt] = (kq, vq, ks, vs, kbyte, vbyte)
        args = (q, kq, vq, ks, vs, lengths)
        got = dec.decode_attention_quantized(*args, sm_scale=scale, **opt)
        if not torch.isfinite(got).all():
            raise AssertionError("quantized decode let NaN padding through")
        check = f"({tag}) decode_attention_quantized/{fmt} local B={B} S={S}"
        want = dec.decode_attention_quantized_plain(*args, sm_scale=scale,
                                                    **opt)
        rec.record(check, "decode_attention_quantized", DECODE_SRC,
                   "leetcuda_tpu/attention/decode.py:308", got, want,
                   time_ms(lambda: dec.decode_attention_quantized(
                       *args, sm_scale=scale, **opt), flush),
                   time_ms(lambda: dec.decode_attention_quantized_plain(
                       *args, sm_scale=scale, **opt), flush, iters=5),
                   time_ms(lambda: sdpa(q[:, :, None], kdq, vdq,
                                        attn_mask=m[:, None, None, :],
                                        scale=scale), flush),
                   4.0 * H * D * n_att,
                   2 * Hkv * n_att * D + 8.0 * Hkv * n_att
                   + 4.0 * B * H * D + 4 * B)
        note(check, lengths=lens_np.tolist(), **opt)
        rec.cap_controls(check, lambda c, s=scale:
                         dec.decode_attention_quantized(
                             *args, sm_scale=s, window=W, softcap=c),
                         want, cap, wrong_scale)
        del kdq, vdq

    # the same caches as shuffled pools of PAGE, NaN wherever no row owns a
    # position; the kernel looks up only the pages of the band
    P = S // PAGE
    n_pages = -(-lens_np // PAGE)
    table, owned = shuffled_table(rec.rng, n_pages, P, dev)
    band_pages = int((n_pages - np.maximum(lens_np - W, 0) // PAGE).sum())
    pools = {None: [to_pool(c, PAGE, table, owned, float("nan"))
                    for c in (kc, vc)]}
    for fmt, (kq, vq, ks, vs, kbyte, vbyte) in quant.items():
        pools[fmt] = [to_pool(c, PAGE, table, owned, f) for c, f in (
            (kq, kbyte), (vq, vbyte), (ks, float("nan")),
            (vs, float("nan")))]
    del kc, vc, quant
    for fmt, pool in pools.items():
        args = (q, *pool, table, lengths)
        if fmt is None:
            name, fn, plain = ("paged_attention", pg.paged_attention,
                               pg.paged_attention_plain)
            kg, vg = kd, vd
            nbytes = 2.0 * (2 * Hkv * n_att * D + 2 * B * H * D)
        else:
            name, fn, plain = ("paged_attention_quantized",
                               pg.paged_attention_quantized,
                               pg.paged_attention_quantized_plain)
            kg = (pg._gather(pool[0], table).float()
                  * pg._gather(pool[2], table)[..., None]).nan_to_num().to(bf)
            vg = (pg._gather(pool[1], table).float()
                  * pg._gather(pool[3], table)[..., None]).nan_to_num().to(bf)
            nbytes = (2 * Hkv * n_att * D + 8.0 * Hkv * n_att
                      + 4.0 * B * H * D)
        got = fn(*args, sm_scale=scale, **opt)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name} read a position no row owns")
        check = f"({tag}) {name}/{fmt or 'bf16'} local page{PAGE}"
        want = plain(*args, sm_scale=scale, **opt)
        rec.record(check, name, DECODE_SRC,
                   "leetcuda_tpu/attention/paged.py:232", got, want,
                   time_ms(lambda: fn(*args, sm_scale=scale, **opt), flush),
                   time_ms(lambda: plain(*args, sm_scale=scale, **opt),
                           flush, iters=5),
                   time_ms(lambda: sdpa(q[:, :, None], kg, vg,
                                        attn_mask=m[:, None, None, :],
                                        scale=scale), flush),
                   4.0 * H * D * n_att, nbytes + 4 * B + 4.0 * band_pages)
        note(check, lengths=lens_np.tolist(), band_pages=band_pages, **opt)
        rec.cap_controls(check, lambda c, s=scale: fn(
            *args, sm_scale=s, window=W, softcap=c), want, cap, wrong_scale)
    del pools, kd, vd, kg, vg

    # the chunk kernel with the cap at T=512 across the window's edge
    cases = (("T=512 local", GEMMA_CHUNK, GEMMA_CHUNK_BASES, None, False, W),
             ("T=512 local", GEMMA_CHUNK, GEMMA_CHUNK_BASES, "fp8", False, W),
             ("T=512 local", GEMMA_CHUNK, GEMMA_CHUNK_BASES, None, True, W),
             ("T=512 global", GEMMA_CHUNK, GEMMA_CHUNK_BASES, None, True,
              None),
             ("T=512 local", GEMMA_CHUNK, GEMMA_CHUNK_BASES, "fp8", True, W))
    chunk_cases(rec, flush, cases, H, Hkv, S, D, sm_scale=scale,
                softcap=cap, prefix=f"({tag}) ", wrong_scale=wrong_scale)
    return skip


@contextlib.contextmanager
def attention_windows(calls):
    """Count the model's attention calls by layer kind into ``calls``:
    "local" when the call carries a window, else "global". Wraps the
    wrappers where models/llama.py and engine/speculative.py look them up
    at call time (the trainable flash attention at its construction, one
    per layer call)."""
    from leetcuda_tpu_torch.engine import speculative as sp
    from leetcuda_tpu_torch.models import llama as ml

    names = {ml: ("decode_attention", "decode_attention_quantized",
                  "paged_attention", "paged_attention_quantized",
                  "flash_attention_ragged", "make_flash_attention_trainable"),
             sp: ("chunk_attention", "chunk_attention_quantized",
                  "paged_chunk_attention", "paged_chunk_attention_quantized")}
    saved = {(m, n): getattr(m, n) for m, ns in names.items() for n in ns}

    def counting(fn):
        def wrapped(*args, **kw):
            kind = "local" if kw.get("window") else "global"
            calls[kind] = calls.get(kind, 0) + 1
            return fn(*args, **kw)
        return wrapped

    for (m, n), fn in saved.items():
        setattr(m, n, counting(fn))
    try:
        yield calls
    finally:
        for (m, n), fn in saved.items():
            setattr(m, n, fn)


def roundoff_control(params, cfg, toks, chunk=GEMMA_CHUNK):
    """Two solo replays of ``toks`` (1, N) that differ only in roundoff:
    ``decode_chunk`` in chunks of ``chunk`` and of ``chunk // 2``. Their
    largest |logit difference|, top-1 agreement and worst gap (the second's
    max logit over its logit of the first's argmax): the floor under the
    teacher-forced gaps of a model."""
    from leetcuda_tpu_torch.engine.speculative import decode_chunk
    from leetcuda_tpu_torch.models.llama import init_kv_caches

    dev, N = toks.device, toks.shape[1]
    runs = []
    for c in (chunk, chunk // 2):
        caches = init_kv_caches(cfg, 1, N + (-N % chunk), device=dev)
        runs.append(torch.cat([decode_chunk(
            params, toks[:, base:base + c], caches,
            torch.tensor([base], dtype=torch.int32, device=dev), cfg)[0]
            for base in range(0, N, c)], 1)[0])
    a, b = runs
    top = a.argmax(-1)
    return {"max_abs_dlogit": float((a - b).abs().max()),
            "top1": float((top == b.argmax(-1)).float().mean()),
            "worst_gap": float((b.max(-1).values
                                - b.gather(1, top[:, None])[:, 0]).max())}


def depth_witness(params, cfg, prompts, control, serve_params=None):
    """Path (o)'s and (r)'s serving at the drawn norms (w = 1), cut to the
    first GEMMA_WITNESS_LAYERS layers at full width (the even ones
    windowed): the paged Engine with chunked prefill over ``prompts`` (over
    ``serve_params``, by default ``params``), each served token
    teacher-forced against its solo replay over ``params`` at LOGIT_TOL,
    and the roundoff control at that depth. Shares the params' tensors."""
    from leetcuda_tpu_torch.engine import Engine, EngineConfig

    n = GEMMA_WITNESS_LAYERS
    wcfg = dataclasses.replace(cfg, n_layers=n)
    wparams = {**params, "layers": params["layers"][:n]}
    sparams = serve_params or params
    sparams = {**sparams, "layers": sparams["layers"][:n]}
    dev = params["embed"].device
    t0 = time.perf_counter()
    eng = Engine(sparams, wcfg, EngineConfig(
        slots=GEMMA_SLOTS, max_seq=GEMMA_MAX_SEQ, prefill_bucket=GEMMA_BUCKET,
        paged=True, page_size=PAGE, prefill_chunk=GEMMA_CHUNK), device=dev)
    served = list(eng.run(prompts, GEMMA_NEW).values())
    del eng
    gaps = [chunk_replay_gap(wparams, wcfg, p, toks)
            for p, toks in zip(prompts, served)]
    res = {"layers": n, "norms": 1.0, "tol": LOGIT_TOL, "gaps": gaps,
           "worst": max(gaps),
           "roundoff_control": roundoff_control(wparams, wcfg, control),
           "seconds": time.perf_counter() - t0}
    if res["worst"] > LOGIT_TOL:
        raise AssertionError(f"{n} layers at w = 1: served tokens off the "
                             f"solo replay: {gaps}")
    return res


def identity_norms(params):
    """Set every norm weight to 0, IN PLACE: under the (1 + w) norms of an
    ``rms_offset`` model, the identity scale."""
    for w in [params["norm"]] + [v for layer in params["layers"]
                                 for k, v in layer.items()
                                 if k.endswith("norm")]:
        w.zero_()


def chunk_replay_gap(params, cfg, prompt, tokens, chunk=GEMMA_CHUNK):
    """Teacher-forced gap of ``tokens`` served after ``prompt``: a solo B=1
    replay of prompt + tokens through ``decode_chunk`` in chunks of at most
    ``chunk`` over a contiguous bf16 cache; the largest (max logit - logit
    of the served token) over the served positions."""
    from leetcuda_tpu_torch.engine.speculative import decode_chunk
    from leetcuda_tpu_torch.models.llama import init_kv_caches

    dev = params["embed"].device
    seq = list(prompt) + list(tokens)
    n, L = len(seq) - 1, len(prompt)  # the last token is no input
    caches = init_kv_caches(cfg, 1, n + (-n % chunk), device=dev)
    toks = torch.tensor(seq, dtype=torch.int32, device=dev)
    gaps = []
    for base in range(0, n, chunk):
        T = min(chunk, n - base)
        logits, caches = decode_chunk(
            params, toks[None, base:base + T], caches,
            torch.tensor([base], dtype=torch.int32, device=dev), cfg)
        lo = max(L - 1 - base, 0)  # rows whose next token was served
        if lo < T:
            rows = logits[0, lo:T]
            tgt = toks[base + lo + 1:base + T + 1].long()
            gaps.append((rows.max(-1).values
                         - rows.gather(1, tgt[:, None])[:, 0]).max())
        del logits
    return float(torch.stack(gaps).max())


def serve_gemma(params, cfg, prompts, lone, ragged, gprompts,
                gen_params=None):
    """Path (o)'s and (r)'s serving: the paged Engine with chunked prefill
    over ``prompts``, then ``lone`` alone; a contiguous Engine admitting
    ``ragged`` in one ragged batch; ``generate`` over ``gprompts`` (over
    ``gen_params``, by default ``params``). Returns timings and the served
    streams."""
    from leetcuda_tpu_torch.engine import Engine, EngineConfig

    dev = params["embed"].device
    eng = Engine(params, cfg, EngineConfig(
        slots=GEMMA_SLOTS, max_seq=GEMMA_MAX_SEQ, prefill_bucket=GEMMA_BUCKET,
        paged=True, page_size=PAGE, prefill_chunk=GEMMA_CHUNK), device=dev)
    t0 = time.perf_counter()
    uids = [eng.submit(p, GEMMA_NEW) for p in prompts]
    first, ticks = {}, 0
    while eng.waiting or eng.active or eng.filling:
        eng.step()
        ticks += 1
        for u in uids:
            if u not in first and (u in eng.finished or any(
                    r.uid == u for r in eng.active.values())):
                first[u] = time.perf_counter() - t0
    sync(dev)
    t_batch = time.perf_counter() - t0
    t1 = time.perf_counter()
    uids.append(eng.submit(lone, GEMMA_LONE_NEW))
    while eng.waiting or eng.active or eng.filling:
        eng.step()
    sync(dev)
    t_lone = time.perf_counter() - t1
    stats = eng.stats()
    if eng.recoveries or eng.preemptions:
        raise AssertionError(f"{eng.recoveries} recoveries, "
                             f"{eng.preemptions} preemptions")
    served = [eng.finished[u].generated for u in uids]
    kv_bytes = eng.kv_memory_report()["target_bytes"]
    del eng
    torch.cuda.empty_cache()

    t2 = time.perf_counter()
    cap = max(map(len, ragged)) + GEMMA_RAGGED_NEW
    reng = Engine(params, cfg, EngineConfig(
        slots=len(ragged), max_seq=cap + (-cap % 1024),
        prefill_bucket=GEMMA_BUCKET), device=dev)
    rserved = list(reng.run(ragged, GEMMA_RAGGED_NEW).values())
    sync(dev)
    t_ragged = time.perf_counter() - t2
    del reng
    torch.cuda.empty_cache()

    gen_, gtoks = serve_generate(gen_params or params, cfg, gprompts,
                                 GEMMA_GEN_NEW)
    for toks, n in zip(served + rserved,
                       [GEMMA_NEW] * len(prompts) + [GEMMA_LONE_NEW]
                       + [GEMMA_RAGGED_NEW] * len(ragged)):
        if len(toks) != n or not all(0 <= x < cfg.vocab_size for x in toks):
            raise AssertionError(f"a request answered {toks}")
    return ({"engine_batch_s": t_batch, "engine_ticks": ticks,
             "first_token_s": [first[u] for u in uids[:len(prompts)]],
             "engine_tok_s": len(prompts) * GEMMA_NEW / t_batch,
             "lone_request_s": t_lone, "ragged_engine_s": t_ragged,
             "kv_bytes": kv_bytes, "engine_stats": {
                 k: v for k, v in stats.items() if isinstance(v, (int, float))},
             **gen_}, served, rserved, gtoks)


# The Gemma 2 serving paths: (o) Gemma-2-27B (head dim 128) over unfused
# params; (r) Gemma-2-9B (head dim 256) with the Engine over dense fused
# params, so that the fused entry block runs at Dh = 256, ``generate`` over
# the unfused ones, and beside every capped phase-3 check one more control
# that must fail: the kernel at the scale of half the head dim, 128^-0.5
# (Gemma-2-9B's own scale is the default, 256^-0.5).
GEMMA_PATHS = {"o": ("Gemma-2-27B", "gemma2_27b_config", False, None),
               "r": ("Gemma-2-9B", "gemma2_9b_config", True, 128 ** -0.5)}


@contextlib.contextmanager
def fused_decode_steps(calls):
    """Count the engine's decode steps over dense fused params (a tensor
    ``wqkv`` in layer 0) into calls["decode_step"]; engine/engine.py looks
    ``decode_step`` up at call time, for the Engine and ``generate``."""
    from leetcuda_tpu_torch.engine import engine as em

    saved = em.decode_step

    def counting(params, *args, **kw):
        if isinstance(params["layers"][0].get("wqkv"), torch.Tensor):
            calls["decode_step"] = calls.get("decode_step", 0) + 1
        return saved(params, *args, **kw)

    em.decode_step = counting
    try:
        yield calls
    finally:
        em.decode_step = saved


def gemma_path(dev="cuda", tag="o"):
    """Path (o): Gemma-2-27B (46 layers, 32 / 16 heads of 128, a 4096-token
    window on the even layers, attention softcap 50, final softcap 30,
    vocab 256000, bf16); path (r) (``tag``): Gemma-2-9B (42 layers, 16 / 8
    heads of 256, the same switches). Phase 3's window and softcap checks
    at its layer-0 shapes first, on the empty card (the plain versions at
    N=8192 hold ~35 GB of f32 scores); then the weights, built on the card
    from a seed (path (r) also fuses them and checks the fused entry block
    on its layer 0); the paged Engine with chunked prefill, a ragged
    admission and ``generate`` (serve_gemma) with the launch counts zeroed
    just before and read just after: exactly one attention launch per layer
    per forward, ragged forward, chunk and decode step, half of them
    windowed (path (r): the fused entry block once per layer per decode
    step over the fused params); served tok/s under the weight-read
    ceiling; every served token teacher-forced against a solo replay over
    the unfused params in chunks of 512 (phase 5); one B=4 decode step at
    context 5120 over the served params profiled, attention device time on
    the local and the global layers apart (phase 6). Returns (rows for the
    kernels line, the path's report).

    The served model's norm weights are 0. ``init_params`` draws them at 1,
    as JAX's does; under Gemma's (1 + w) norms that doubles every
    normalised vector, q and k among them, so the random model's attention
    scores spread ~3.8 wide and the model is chaotic: two replays that
    differ only in roundoff (``roundoff_control``, 512- against 256-token
    chunks of one 1024-token prompt) then disagree on the argmax at most
    positions, and no teacher-forced check can tell a fault from roundoff.
    The control runs on both weight sets each run and is reported; at w = 0
    (the identity scale) it agrees to roundoff. At w = 1 the Engine's
    serving is held at a depth of GEMMA_WITNESS_LAYERS (``depth_witness``),
    where roundoff does not grow into another argmax."""
    from leetcuda_tpu_torch.engine import generate
    from leetcuda_tpu_torch.models import llama as ml

    model, cfg_name, fused, wrong_scale = GEMMA_PATHS[tag]
    cfg = getattr(ml, cfg_name)()
    res = {"model": model, "tag": tag, "fused": fused,
           "config": {k: (str(v) if isinstance(v, torch.dtype) else v)
                      for k, v in dataclasses.asdict(cfg).items()}}
    t0 = time.perf_counter()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rec = Recorder(dev)
    res["band_skip"] = check_attn_options(rec, flush, cfg, tag, wrong_scale)
    res["phase3_s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    params = ml.init_params(torch.Generator(device=dev).manual_seed(
        GEMMA_SEED), cfg, device=dev)
    sync(params["embed"].device)
    res.update(init_s=time.perf_counter() - t1,
               weight_bytes=param_bytes(params),
               n_params=sum(p.numel() for _, p in ml.named_leaves(params)))
    sparams = params  # the Engine's params
    if fused:
        sparams = ml.fuse_params(params)  # the norms stay shared
        t2 = time.perf_counter()
        check_fused(rec, flush, sparams["layers"][0], cfg)
        res["fused_check_s"] = time.perf_counter() - t2
    del flush
    torch.cuda.empty_cache()
    # a B=4 step reads every weight once: the tok/s ceiling
    res["tok_s_ceiling"] = GEMMA_SLOTS / (res["weight_bytes"]
                                          / HBM_BYTES_PER_S)

    rng = np.random.default_rng(GEMMA_SEED + 1)
    control = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, 2 * GEMMA_CHUNK)).astype(np.int32)).to(dev)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in GEMMA_PLENS]
    lone = rng.integers(0, cfg.vocab_size, GEMMA_LONE).tolist()
    ragged = [rng.integers(0, cfg.vocab_size, n).tolist()
              for n in GEMMA_RAGGED]
    gprompts = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (GEMMA_GEN_B, GEMMA_GEN_S)).astype(
            np.int32)).to(dev)
    with torch.no_grad():
        res["witness_w1"] = depth_witness(params, cfg, prompts, control,
                                          sparams)
        res["roundoff_control"] = {
            "norms at 1": roundoff_control(params, cfg, control)}
        identity_norms(params)
        res["roundoff_control"]["norms at 0"] = roundoff_control(
            params, cfg, control)
    generate(sparams, cfg, gprompts[:1, :16], 2, device=dev)  # warm-up
    calls, kinds, fsteps = {}, {}, {}

    def serve():
        with model_calls(calls), attention_windows(kinds), \
                fused_decode_steps(fsteps):
            return serve_gemma(sparams, cfg, prompts, lone, ragged, gprompts,
                               params)

    (out, served, rserved, gtoks), counts, peak = drive(tag, serve)
    res.update(out, launches=counts, model_calls=calls,
               attention_calls=kinds, peak_extra_bytes=peak,
               fused_decode_steps=fsteps.get("decode_step", 0),
               peak_bytes=torch.cuda.max_memory_allocated())
    n_calls = sum(calls.values())
    attn = sum(counts.get(n, 0) for n in ATTN_COUNTERS)
    if attn != cfg.n_layers * n_calls or any(
            counts.get(n, 0) % cfg.n_layers for n in ATTN_COUNTERS):
        raise AssertionError(f"path {tag}: {attn} attention launches for "
                             f"{calls}, not one per layer per call "
                             f"({cfg.n_layers * n_calls}): {counts}")
    half = cfg.n_layers // 2 * n_calls
    if kinds != {"local": half, "global": half}:
        raise AssertionError(f"path {tag}: attention calls by layer {kinds}, "
                             f"not {half} windowed and {half} global")
    fused_want = cfg.n_layers * res["fused_decode_steps"]
    if counts.get("fused_norm_qkv_rope", 0) != fused_want or (
            fused and not fused_want):
        raise AssertionError(f"path {tag}: {counts.get('fused_norm_qkv_rope')}"
                             f" fused entry blocks for "
                             f"{res['fused_decode_steps']} decode steps over "
                             f"fused params")
    for what in ("engine_tok_s", "generate_tok_s"):
        if res[what] > res["tok_s_ceiling"]:
            raise AssertionError(f"path {tag}: {what} {res[what]:.1f} "
                                 f"exceeds its ceiling "
                                 f"{res['tok_s_ceiling']:.1f}")

    # phase 5: every served stream against a solo replay in chunks
    t5 = time.perf_counter()
    gaps = {}
    for i, (p, toks) in enumerate(zip(prompts + [lone], served)):
        gaps[f"engine/{i}"] = chunk_replay_gap(params, cfg, p, toks)
    for i, (p, toks) in enumerate(zip(ragged, rserved)):
        gaps[f"ragged/{i}"] = chunk_replay_gap(params, cfg, p, toks)
    for b, toks in enumerate(gtoks.tolist()):
        gaps[f"generate/{b}"] = chunk_replay_gap(
            params, cfg, gprompts[b].tolist(), toks)
    res["teacher_forced"] = {"tol": LOGIT_TOL, "worst": max(gaps.values()),
                             "gaps": gaps,
                             "seconds": time.perf_counter() - t5}
    if res["teacher_forced"]["worst"] > LOGIT_TOL:
        raise AssertionError(f"path {tag}: served tokens off the solo "
                             f"replay: {gaps}")

    # phase 6: one B=4 decode step at context 5120, attention by layer kind
    res["profile"] = profile_decode(
        sparams, cfg, batch=GEMMA_SLOTS, context=GEMMA_PLENS[0],
        classes={"attention": ("decode_attn",)},
        split=("decode_attn", cfg.n_layers))
    return rec.rows, res


def print_gemma(rows, res):
    c = res["config"]
    for r in rows.values():
        lib = (f"library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else "library none")
        print(f"kernel {r['check']}: max_abs_err {r['max_abs_err']:.3g} "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms {lib} "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    bs, tag = res["band_skip"], res["tag"]
    print(f"band skip (1, {bs['H']}, {bs['N']}, {bs['D']}): window "
          f"{bs['window']} "
          f"{bs['local_ms']:.4f} ms, causal {bs['global_ms']:.4f} ms, ratio "
          f"{bs['ratio']:.3f} (tiles {bs['tile_ratio']:.3f}, bar "
          f"{bs['max_ratio']})")
    print(f"path ({tag}) {res['model']} ({c['n_layers']} layers, "
          f"{res['n_params'] / 1e9:.2f}B params, head dim "
          f"{c['head_dim_override']}, window "
          f"{c['sliding_window']} on even layers, softcap "
          f"{c['attn_softcap']} / {c['final_softcap']}, bf16, random weights "
          f"built in {res['init_s']:.1f} s): paged Engine"
          f"{' over dense fused params' if res['fused'] else ''}, "
          f"prefill_chunk "
          f"{GEMMA_CHUNK}, {len(GEMMA_PLENS)} requests (prompts "
          f"{list(GEMMA_PLENS)}) x {GEMMA_NEW} tokens in "
          f"{res['engine_batch_s']:.3f} s = {res['engine_tok_s']:.1f} tok/s "
          f"({res['engine_ticks']} ticks; first tokens at "
          f"{[round(x, 3) for x in res['first_token_s']]} s); lone "
          f"{GEMMA_LONE}-token request {res['lone_request_s']:.3f} s; ragged "
          f"admission {list(GEMMA_RAGGED)} x {GEMMA_RAGGED_NEW}: "
          f"{res['ragged_engine_s']:.3f} s; generate B={GEMMA_GEN_B} "
          f"S={GEMMA_GEN_S} x {GEMMA_GEN_NEW}: {res['generate_s']:.3f} s = "
          f"{res['generate_tok_s']:.1f} tok/s; ceiling "
          f"{res['tok_s_ceiling']:.1f} tok/s; params "
          f"{res['weight_bytes'] / 2**30:.2f} GiB, pool "
          f"{res['kv_bytes'] / 2**30:.2f} GiB, peak device memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"  model calls {res['model_calls']}; attention calls by layer "
          f"{res['attention_calls']}; decode steps over fused params "
          f"{res['fused_decode_steps']}; launches: {res['launches']}")
    tf = res["teacher_forced"]
    print(f"  teacher-forced: worst gap {tf['worst']:.4f} (tol {tf['tol']}) "
          f"over {len(tf['gaps'])} streams in {tf['seconds']:.1f} s")
    print(f"  roundoff control (one prompt, chunks of {GEMMA_CHUNK} against "
          f"{GEMMA_CHUNK // 2}): {res['roundoff_control']}")
    wit = res["witness_w1"]
    print(f"  witness at w = 1, {wit['layers']} layers: teacher-forced gaps "
          f"{[round(g, 4) for g in wit['gaps']]} (tol {wit['tol']}), roundoff "
          f"control {wit['roundoff_control']}, {wit['seconds']:.1f} s")
    for r in rows.values():
        if "cap_controls" in r:
            print(f"  cap control {r['check']}: {r['cap_controls']} (bar "
                  f"{KERNEL_TOL})")
    prof = res["profile"]
    print_profile(f"({tag}) {res['model']}, contiguous bf16 cache"
                  + (", dense fused params" if res["fused"] else ""), prof)
    split = prof.get("split_ms")
    print(f"  attention device ms a step: "
          + ("not measured" if not split else
             f"windowed layers {split['even']:.4f}, global layers "
             f"{split['odd']:.4f} ({split['launches']} launches)"),
          flush=True)


# Path (s) trains Gemma-2-2B (models/llama.py gemma2_2b_config: 26 layers,
# 8 / 4 heads of 256, a 4096-token window on the even layers, caps 50 / 30)
# at its published width and depth and context, B=1 x S=8192, so that the
# window bands the even layers' backward: random bf16 weights from
# GEMMA_TRAIN_SEED with the (1 + w) norms at w = 0 (Gemma's own init and
# path (o)'s served scale; see ``gemma_path``), AdamW at TRAIN_LR under
# remat, GEMMA_TRAIN_WARMUP + 4 timed steps on crops of the learnable
# corpus. Its phase 3 holds the backward kernels at (1, 8, 8192, 256) with
# 4 KV heads (GEMMA_BWD_N): causal, the local layer's window 4096 with cap
# 50, and the same at BWD_CAP with the cap's controls and a wrong scale's.
GEMMA_TRAIN_SEED = 13
GEMMA_TRAIN_B, GEMMA_TRAIN_S = 1, 8192
GEMMA_TRAIN_STEPS, GEMMA_TRAIN_WARMUP = 6, 2
GEMMA_REPLAY_B, GEMMA_REPLAY_S = 1, 2048
GEMMA_BWD_N = 8192


def gemma_train_path(dev="cuda"):
    """Path (s): phase 3's backward checks at Gemma-2-2B's training shape
    on the empty card; then its weights; one B=1, S=2048 step replayed
    against the plain attention forward and backward (``replay_train_step``,
    path (i)'s bounds); then ``train`` at B=1, S=8192 with the launch counts
    zeroed just before and read just after (each step: the forward with
    its lse twice per layer, dQ and dK/dV once, nothing else), a falling
    loss. Returns (rows for the kernels line, the path's report)."""
    from leetcuda_tpu_torch.models.llama import gemma2_2b_config, init_params

    cfg = gemma2_2b_config()
    W, cap = cfg.sliding_window, cfg.attn_softcap
    res = {"model": "Gemma-2-2B",
           "config": {k: (str(v) if isinstance(v, torch.dtype) else v)
                      for k, v in dataclasses.asdict(cfg).items()}}
    t0 = time.perf_counter()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rec = Recorder(dev)
    shape = (1, cfg.n_heads, cfg.n_kv_heads, GEMMA_BWD_N, cfg.head_dim)
    for label, window, c, wrong in (
            ("causal", None, None, None),
            (f"window {W}, cap {cap:g}", W, cap, None),
            (f"window {W}, cap {BWD_CAP:g}", W, BWD_CAP,
             (cfg.head_dim // 2) ** -0.5)):
        bwd_case(rec, flush, f"D={cfg.head_dim} {label}", shape, True,
                 window=window, cap=c, prefix="(s) ", wrong_scale=wrong)
    del flush
    torch.cuda.empty_cache()
    res["phase3_s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(
        GEMMA_TRAIN_SEED), cfg, device=dev)
    identity_norms(params)
    sync(params["embed"].device)
    res["init_s"] = time.perf_counter() - t1
    corpus = train_corpus(cfg.vocab_size, 200_000, seed=0)
    rng = np.random.default_rng(GEMMA_TRAIN_SEED + 1)
    t2 = time.perf_counter()
    res["replay"] = replay_train_step(cfg, params, crops(
        corpus, rng, GEMMA_REPLAY_B, GEMMA_REPLAY_S, dev))
    res["replay"]["seconds"] = time.perf_counter() - t2
    res["replay"].update(batch=GEMMA_REPLAY_B, seq=GEMMA_REPLAY_S)
    torch.cuda.empty_cache()
    (out, _, _, _), counts, peak = drive("s", lambda: train(
        cfg, params, corpus, rng, B=GEMMA_TRAIN_B, S=GEMMA_TRAIN_S,
        steps=GEMMA_TRAIN_STEPS, warmup=GEMMA_TRAIN_WARMUP))
    res.update(out, launches=counts, peak_extra_bytes=peak,
               peak_bytes=torch.cuda.max_memory_allocated(),
               corpus_distinct_tokens=int(np.unique(corpus).size))
    return rec.rows, res


def print_gemma_train(rows, res):
    c = res["config"]
    for r in rows.values():
        errs = ", ".join(f"{n} {e:.3g}" for n, e in r["rel_l2"].items())
        print(f"kernel {r['check']}: max_abs_err {r['max_abs_err']:.3g} "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms library "
              f"{r['library_ms']:.4f} ms ({r['library_kernel']}) bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}); relative L2 "
              f"{errs}; whole backward {r['backward_ms']:.4f} ms; controls "
              f"{r['cap_controls_rel_l2']}", flush=True)
    rp = res["replay"]
    print(f"path (s) replayed step B={rp['batch']} S={rp['seq']}: loss "
          f"{rp['loss_kernels']:.6f} through the kernels, "
          f"{rp['loss_plain']:.6f} through the plain attention (relative "
          f"{rp['loss_rel_err']:.2e}, tol {REPLAY_LOSS_TOL}); worst gradient "
          f"relative L2 {rp['worst_grad_rel_l2_plain']:.2e} "
          f"({rp['worst_grad_plain']}, tol {REPLAY_GRAD_TOL}); against the "
          f"kernel forward with the plain backward "
          f"{rp['worst_grad_rel_l2_plain_bwd']:.2e} "
          f"({rp['worst_grad_plain_bwd']}, tol {REPLAY_BWD_TOL}), roundoff "
          f"floor {rp['worst_grad_rel_l2_nudged']:.2e}; backward kernels per "
          f"layer {rp['worst_call_rel_l2']:.2e} at worst (tol "
          f"{REPLAY_CALL_TOL}) in {rp['seconds']:.1f} s", flush=True)
    print(f"path (s) {res['model']} training ({c['n_layers']} layers, "
          f"{res['n_params'] / 1e9:.3f}B params, head dim "
          f"{c['head_dim_override']}, window {c['sliding_window']} on even "
          f"layers), make_train_step remat, AdamW lr {TRAIN_LR}, "
          f"B={res['batch']} S={res['seq']}: losses "
          f"{[round(x, 4) for x in res['losses']]}; after "
          f"{GEMMA_TRAIN_WARMUP} warm-up steps {res['step_s']:.4f} s a step "
          f"= {res['tok_s']:.1f} tok/s, model-FLOP share "
          f"{res['model_flop_share']:.4f} of {BF16_FLOP_PER_S / 1e12:.0f} "
          f"TFLOP/s; peak device memory {res['peak_bytes'] / 2**30:.2f} GiB; "
          f"corpus cycle {res['corpus_distinct_tokens']} tokens; phase 3 "
          f"{res['phase3_s']:.1f} s", flush=True)
    print(f"  launches: {res['launches']}")


# Path (p) serves GPT-OSS-20B (models/llama.py gpt_oss_20b_config) at its
# published width and depth, random bf16 weights from GPTOSS_SEED: attention
# sinks on every layer, a 128-token window on the even layers, q/k/v/o
# biases and 32 experts of 2880 (top-4) in JAX's dense combine, ~20.9B
# parameters (41.8 GB). The paged Engine (pages of PAGE, 4 slots of 1024
# positions, chunked prefill of 256 prompt tokens a tick) serves prompts of
# 640, 400, 300 and 200 tokens (all past the window) x 32 new, and over
# int8 pools 300 and 200 tokens x 16 new; a contiguous Engine admits 300
# and 150 tokens in one ragged batch, 16 new each; ``generate`` runs at B=8
# over 128-token prompts and at B=4 over an int8 KV cache, 32 new tokens
# each. Its speculative part (spec_k 3, the model's first GPTOSS_DRAFT
# layers as the draft): ``speculative_generate`` at B=2 over 128-token
# prompts, 16 new, and the speculative Engine over an int8 contiguous cache
# serving the ragged admission's prompts, 16 new.
GPTOSS_SEED = 7
GPTOSS_PLENS, GPTOSS_NEW = (640, 400, 300, 200), 32
GPTOSS_SLOTS, GPTOSS_MAX_SEQ, GPTOSS_CHUNK = 4, 1024, 256
GPTOSS_RAGGED, GPTOSS_RAGGED_NEW = (300, 150), 16
GPTOSS_GEN_B, GPTOSS_GEN_S, GPTOSS_GEN_NEW = 8, 128, 32
GPTOSS_Q_B = 4  # generate over an int8 KV cache
GPTOSS_QPAGED = (300, 200)  # the paged Engine over int8 pools
GPTOSS_DRAFT, GPTOSS_SPEC_B, GPTOSS_SPEC_NEW = 2, 2, 16
GPTOSS_EXPERTS = 32  # num_local_experts (the experts are structure-driven)
# the random biases' scale (attention and experts)
GPTOSS_BIAS = 0.1
# the served router (see gptoss_path): per-expert biases GPTOSS_ROUTER_GAP
# apart, the drawn router matrix scaled by GPTOSS_ROUTER_SCALE, so that the
# 4th and 5th logits of a token stand ~7 noise deviations apart
GPTOSS_ROUTER_GAP, GPTOSS_ROUTER_SCALE = 0.5, 0.05
# phase 3 of path (p), at its layer-0 shapes (B=8, 64 / 8 heads of 64, a
# capacity of 2048): decode lengths 0, below, at and past the window of 128;
# chunk bases whose T=4 rows sit below, across and past it, and T=512 rows
# from 0 (crossing it) and from 1024
LSE_DECODE_LENS = np.array([0, 100, 128, 129, 517, 1024, 1500, 2000],
                           np.int32)
LSE_CHUNK_BASES = {4: np.array([0, 100, 124, 125, 517, 1024, 1500, 2044],
                               np.int32),
                   512: np.array([0, 1024], np.int32)}
LSE_S = 2048
LN2 = math.log(2.0)


def lse_controls(rec, check, want_lse, run, window):
    """Beside the lse check ``check``: the kernel's lse in log2 units
    (lse / ln 2) and, on a windowed layer, the lse of the unwindowed rows
    (``run(None)``, the kernel without the window) must fail KERNEL_TOL
    against ``want_lse``, the plain lse. Records the largest differences."""
    got = run(window)
    cands = {"log2 units": got / LN2}
    if window:
        cands["unwindowed"] = run(None)
    errs = {}
    for label, x in cands.items():
        errs[label] = float((x.float() - want_lse.float()).abs().max())
        if torch.allclose(x.float(), want_lse.float(), **KERNEL_TOL):
            raise AssertionError(f"{check}: the lse control '{label}' "
                                 f"passes the check")
    rec.rows[check]["lse_controls"] = errs


def lse_case(rec, flush, check, name, src, replaces, fn, plain, args, kw,
             flops, nbytes, lse_bytes, lib):
    """One ``with_lse`` check: the kernel's (out, lse) against its plain
    version's (the out at KERNEL_TOL too; NaN padding must not reach it),
    timed with and without the lse beside the plain version (with the lse)
    and ``lib``, one library call of the same attention without the lse;
    the lse's controls (``lse_controls``)."""
    got, got_lse = fn(*args, with_lse=True, **kw)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{check}: NaN padding reached the output")
    want, want_lse = plain(*args, with_lse=True, **kw)
    out_err = hold(got, want)
    ms = time_ms(lambda: fn(*args, with_lse=True, **kw), flush)
    ms_without = time_ms(lambda: fn(*args, **kw), flush)
    plain_ms = time_ms(lambda: plain(*args, with_lse=True, **kw), flush,
                       iters=5)
    rec.record(check, name, src, replaces, got_lse, want_lse, ms, plain_ms,
               time_ms(lib, flush), flops, nbytes + lse_bytes)
    b_s, _ = bound(flops, nbytes)
    rec.rows[check].update(out_max_abs_err=out_err, ms_without_lse=ms_without,
                           bound_without_lse_ms=b_s * 1e3,
                           library="SDPA, output only", **kw)
    lse_controls(rec, check, want_lse, lambda w: fn(
        *args, with_lse=True, **{**kw, "window": w})[1], kw.get("window"))


def check_lse(rec, flush, cfg):
    """Phase 3 of path (p): the ``with_lse`` option of decode (bf16, int8,
    e4m3), paged (bf16 pools, int8 and e4m3 pools) and chunk (T=4 and T=512
    over contiguous bf16 / int8 caches and paged bf16 / e4m3 pools) at
    GPT-OSS-20B's layer-0 shapes (B=8, 64 / 8 heads of 64, capacity 2048),
    a windowed layer (128) and a global one, NaN past every length (e4m3:
    the NaN bytes, int8: zeros with NaN scales), paged over shuffled pages
    of 128 with NaN in every position no row owns. Each (out, lse) against
    its plain version at KERNEL_TOL, with its two controls
    (``lse_controls``); each kernel timed with and without the lse, each
    bound counting the attended positions only (and the lse's 4 bytes a
    row), beside SDPA over the gathered, dequantized cache with the band
    as a mask."""
    from leetcuda_tpu_torch.attention import chunk as ck
    from leetcuda_tpu_torch.attention import decode as dec
    from leetcuda_tpu_torch.attention import paged as pg
    from leetcuda_tpu_torch.core.runtime import as_bytes
    from leetcuda_tpu_torch.models.llama import _quantize_token_kv

    dev, bf = rec.dev, torch.bfloat16
    H, Hkv, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, LSE_S
    W = cfg.sliding_window
    windows = {"local": W, "global": None}
    qdts = {"fp8": torch.float8_e4m3fn, "int8": torch.int8}

    # decode and paged: B=8 rows of LSE_DECODE_LENS
    lens_np = LSE_DECODE_LENS
    B = len(lens_np)
    lengths = torch.from_numpy(lens_np).to(dev)
    cols = torch.arange(S, device=dev)[None, :]
    past = (cols >= lengths[:, None])[:, None, :].expand(B, Hkv, S)
    q = rec.randn(B, H, D)
    kc, vc = rec.randn(B, Hkv, S, D), rec.randn(B, Hkv, S, D)
    caches = {None: ([kc, vc], [float("nan")] * 2, kc, vc)}
    for fmt, qdt in qdts.items():
        kq, ks = _quantize_token_kv(kc, qdt)
        vq, vs = _quantize_token_kv(vc, qdt)
        kd, vd = ((x.float() * s[..., None]).to(bf) for x, s in ((kq, ks),
                                                                 (vq, vs)))
        kbyte, vbyte = (0x7F, 0xFF) if fmt == "fp8" else (0, 0)
        ks[past], vs[past] = float("nan"), float("nan")
        as_bytes(kq)[past], as_bytes(vq)[past] = kbyte, vbyte
        caches[fmt] = ([kq, vq, ks, vs], [kbyte, vbyte, float("nan"),
                                          float("nan")], kd, vd)
    kc[past], vc[past] = float("nan"), float("nan")
    P = S // PAGE
    n_pages = -(-lens_np // PAGE)
    table, owned = shuffled_table(rec.rng, n_pages, P, dev)
    for layer, w in windows.items():
        m = cols < lengths[:, None]
        if w:
            m = m & (cols >= lengths[:, None] - w)
        n_att = int(m.sum())
        mask = m[:, None, None, :]
        for fmt, (tensors, fills, kd, vd) in caches.items():
            kd, vd = torch.nan_to_num(kd), torch.nan_to_num(vd)
            elt_bytes = (2.0 * 2 * Hkv * n_att * D if fmt is None else
                         2.0 * Hkv * n_att * D + 8.0 * Hkv * n_att)
            nbytes = elt_bytes + 2.0 * 2 * B * H * D + 4 * B
            kw = {"window": w} if w else {}
            for paged in (False, True):
                if paged:
                    args = (q, *[to_pool(t, PAGE, table, owned, f)
                                 for t, f in zip(tensors, fills)], table,
                            lengths)
                    fn, plain = ((pg.paged_attention,
                                  pg.paged_attention_plain) if fmt is None
                                 else (pg.paged_attention_quantized,
                                       pg.paged_attention_quantized_plain))
                    band = int((-(-lens_np // PAGE) - (np.maximum(
                        lens_np - w, 0) // PAGE if w else 0)).sum())
                    extra = 4.0 * band
                    replaces = "leetcuda_tpu/attention/paged.py:232"
                else:
                    args = (q, *tensors, lengths)
                    fn, plain = ((dec.decode_attention,
                                  dec.decode_attention_plain) if fmt is None
                                 else (dec.decode_attention_quantized,
                                       dec.decode_attention_quantized_plain))
                    extra = 0.0
                    replaces = ("leetcuda_tpu/attention/decode.py:"
                                + ("223" if fmt is None else "308"))
                name = fn.__name__ + "_lse"
                check = (f"(p) {name}/{fmt or 'bf16'} {layer} B={B} S={S}"
                         + (f" page{PAGE}" if paged else ""))
                lse_case(rec, flush, check, name, DECODE_SRC, replaces, fn,
                         plain, args, kw, 4.0 * H * D * n_att, nbytes + extra,
                         4.0 * B * H,
                         lambda kd=kd, vd=vd, mask=mask: sdpa(
                             q[:, :, None], kd, vd, attn_mask=mask))
                rec.rows[check]["lengths"] = lens_np.tolist()
    del caches, kc, vc, q

    # chunk: T=4 (verify) and T=512 (chunked prefill), the four entry points
    for T, bases_np in LSE_CHUNK_BASES.items():
        B = len(bases_np)
        base = torch.from_numpy(bases_np).to(dev)
        end_np = np.minimum(bases_np + T, S)
        ccols = torch.arange(S, device=dev)
        past = (ccols[None, :] >= torch.from_numpy(end_np).to(dev)[:, None])
        past = past[:, None, :].expand(B, Hkv, S)
        q = rec.randn(B, H, T, D)
        kc, vc = rec.randn(B, Hkv, S, D), rec.randn(B, Hkv, S, D)
        lay = {}
        for fmt, paged in ((None, False), ("int8", False), (None, True),
                           ("fp8", True)):
            if fmt is None:
                k_, v_ = kc.clone(), vc.clone()
                k_[past], v_[past] = float("nan"), float("nan")
                tensors, fills, kd, vd = [k_, v_], [float("nan")] * 2, kc, vc
            else:
                kq, ks = _quantize_token_kv(kc, qdts[fmt])
                vq, vs = _quantize_token_kv(vc, qdts[fmt])
                kd, vd = ((x.float() * s_[..., None]).to(bf)
                          for x, s_ in ((kq, ks), (vq, vs)))
                kbyte, vbyte = (0x7F, 0xFF) if fmt == "fp8" else (0, 0)
                ks[past], vs[past] = float("nan"), float("nan")
                as_bytes(kq)[past], as_bytes(vq)[past] = kbyte, vbyte
                tensors = [kq, vq, ks, vs]
                fills = [kbyte, vbyte, float("nan"), float("nan")]
            tbl_bytes = 0.0
            if paged:
                n_pages = -(-end_np // PAGE)
                table, owned = shuffled_table(rec.rng, n_pages, S // PAGE,
                                              dev)
                tensors = [to_pool(t, PAGE, table, owned, f)
                           for t, f in zip(tensors, fills)] + [table]
                tbl_bytes = 4.0 * int(n_pages.sum())
            lay[(fmt, paged)] = ((q, *tensors, base), kd, vd, tbl_bytes)
        for layer, w in windows.items():
            limit = np.minimum(bases_np[:, None] + np.arange(T)[None, :] + 1,
                               S)
            low = (np.zeros_like(limit) if w is None else np.maximum(
                bases_np[:, None] + np.arange(T)[None, :] + 1 - w, 0))
            pairs = int(np.maximum(limit - low, 0).sum())
            n_pos = int((end_np - low[:, 0]).sum())
            lim_t = base[:, None] + torch.arange(T, device=dev)[None, :] + 1
            mask = ccols[None, None, :] < lim_t[:, :, None]
            if w:
                mask &= ccols[None, None, :] >= lim_t[:, :, None] - w
            mask = mask[:, None]
            kw = {"window": w} if w else {}
            for (fmt, paged), (args, kd, vd, tbl_bytes) in lay.items():
                fn, plain = {
                    (False, False): (ck.chunk_attention,
                                     ck.chunk_attention_plain),
                    (True, False): (ck.chunk_attention_quantized,
                                    ck.chunk_attention_quantized_plain),
                    (False, True): (ck.paged_chunk_attention,
                                    ck.paged_chunk_attention_plain),
                    (True, True): (ck.paged_chunk_attention_quantized,
                                   ck.paged_chunk_attention_quantized_plain),
                }[(fmt is not None, paged)]
                elt = 2 if fmt is None else 1
                nbytes = (2.0 * Hkv * n_pos * D * elt
                          + (8.0 * Hkv * n_pos if fmt else 0.0)
                          + 2 * 2.0 * B * H * T * D + 4 * B + tbl_bytes)
                name = fn.__name__ + "_lse"
                check = (f"(p) {name}/T={T} {fmt or 'bf16'} {layer}"
                         + (f" page{PAGE}" if paged else ""))
                kd0, vd0 = torch.nan_to_num(kd), torch.nan_to_num(vd)
                lse_case(rec, flush, check, name, CHUNK_SRC,
                         "leetcuda_tpu/attention/chunk.py:"
                         + ("287" if paged else "207"), fn, plain, args, kw,
                         4.0 * H * D * pairs, nbytes, 4.0 * B * H * T,
                         lambda kd0=kd0, vd0=vd0, mask=mask: sdpa(
                             q, kd0, vd0, attn_mask=mask))
                rec.rows[check].update(T=T, bases=bases_np.tolist())
        del lay, kc, vc, q


def gptoss_params(cfg, seed, dev):
    """GPT-OSS's weights from a seed on ``dev``: ``init_params`` (attention,
    norms, the sinks, the embedding; its dense MLP dropped), then what the
    JAX loader lays out beside them (loader.py:282-313): q/k/v/o biases,
    ``moe_oss`` (router (D, E) and its bias in f32; w_gate_up (E, D, 2F)
    with gate and up interleaved, w_down (E, F, D) and their biases) and
    the untied head, each drawn one layer at a time."""
    from leetcuda_tpu_torch.models.llama import init_params

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(gen, cfg, device=dev)
    D, H, Hkv, Dh = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    E, F_ = GPTOSS_EXPERTS, cfg.ffn_dim

    def draw(shape, scale, dtype=cfg.dtype):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=gen.device) * scale).to(dev, dtype)

    for layer in params["layers"]:
        for key in ("w_gate", "w_up", "w_down"):
            del layer[key]
        layer.update(bq=draw((H * Dh,), GPTOSS_BIAS),
                     bk=draw((Hkv * Dh,), GPTOSS_BIAS),
                     bv=draw((Hkv * Dh,), GPTOSS_BIAS),
                     bo=draw((D,), GPTOSS_BIAS))
        layer["moe_oss"] = {
            "router_w": draw((D, E), D ** -0.5, torch.float32),
            "router_b": draw((E,), GPTOSS_BIAS, torch.float32),
            "w_gate_up": draw((E, D, 2 * F_), D ** -0.5),
            "b_gate_up": draw((E, 2 * F_), GPTOSS_BIAS),
            "w_down": draw((E, F_, D), F_ ** -0.5),
            "b_down": draw((E, D), GPTOSS_BIAS)}
    params["lm_head"] = draw((cfg.vocab_size, D), D ** -0.5)
    return params


def margin_router(params, seed):
    """Give every layer's router margins, IN PLACE: distinct biases
    GPTOSS_ROUTER_GAP apart in a per-layer random order, and the router
    matrix scaled by GPTOSS_ROUTER_SCALE. The top-4 set then no longer
    flips on roundoff; the four weights still softmax the selected logits."""
    gen = torch.Generator().manual_seed(seed)
    for layer in params["layers"]:
        moe = layer["moe_oss"]
        E = moe["router_b"].shape[0]
        rank = torch.randperm(E, generator=gen).float()
        moe["router_b"].copy_(rank * GPTOSS_ROUTER_GAP)
        moe["router_w"].mul_(GPTOSS_ROUTER_SCALE)


def prefill_roundoff_control(params, cfg, toks, chunk=512):
    """Two solo replays of ``toks`` (1, N) that differ only in roundoff:
    ``forward`` (the flash kernel, one call) and ``decode_chunk`` in chunks
    of ``chunk`` (the chunk kernel, other GEMM shapes). Their largest
    |logit difference|, top-1 agreement and worst gap (the chunk replay's
    max logit over its logit of the forward's argmax): the floor under the
    teacher-forced gaps of a model whose served and replayed tokens took
    those two paths."""
    from leetcuda_tpu_torch.engine.speculative import decode_chunk
    from leetcuda_tpu_torch.models.llama import forward, init_kv_caches

    dev, N = toks.device, toks.shape[1]
    a = forward(params, toks, cfg)[0]
    caches = init_kv_caches(cfg, 1, N + (-N % chunk), device=dev)
    b = torch.cat([decode_chunk(
        params, toks[:, base:base + chunk], caches,
        torch.tensor([base], dtype=torch.int32, device=dev), cfg)[0]
        for base in range(0, N, chunk)], 1)[0]
    top = a.argmax(-1)
    return {"max_abs_dlogit": float((a - b).abs().max()),
            "top1": float((top == b.argmax(-1)).float().mean()),
            "worst_gap": float((b.max(-1).values
                                - b.gather(1, top[:, None])[:, 0]).max())}


def serve_gptoss(params, cfg, prompts, qpaged, ragged, gprompts, qprompts):
    """Path (p)'s serving: the paged Engine with chunked prefill over
    ``prompts`` (bf16 pools) and ``qpaged`` (int8 pools); a contiguous
    Engine admitting ``ragged`` in one ragged batch; ``generate`` over
    ``gprompts`` (bf16 cache) and ``qprompts`` (int8 KV). Returns timings
    and the served streams."""
    from leetcuda_tpu_torch.engine import Engine, EngineConfig

    dev = params["embed"].device
    runs = {}
    for kvq, reqs, new in ((None, prompts, GPTOSS_NEW),
                           ("int8", qpaged, GPTOSS_RAGGED_NEW)):
        eng = Engine(params, cfg, EngineConfig(
            slots=GPTOSS_SLOTS, max_seq=GPTOSS_MAX_SEQ, prefill_bucket=128,
            paged=True, page_size=PAGE, prefill_chunk=GPTOSS_CHUNK,
            kv_quant=kvq), device=dev)
        t0 = time.perf_counter()
        uids = [eng.submit(p, new) for p in reqs]
        ticks = 0
        while eng.waiting or eng.active or eng.filling:
            eng.step()
            ticks += 1
        sync(dev)
        if eng.recoveries or eng.preemptions:
            raise AssertionError(f"path p: {eng.recoveries} recoveries, "
                                 f"{eng.preemptions} preemptions")
        runs[kvq] = (time.perf_counter() - t0, ticks,
                     [eng.finished[u].generated for u in uids],
                     eng.kv_memory_report()["target_bytes"])
        del eng
        torch.cuda.empty_cache()
    t_batch, ticks, served, kv_bytes = runs[None]
    qserved = runs["int8"][2]

    t1 = time.perf_counter()
    reng = Engine(params, cfg, EngineConfig(
        slots=len(ragged), max_seq=GPTOSS_MAX_SEQ, prefill_bucket=128),
        device=dev)
    rserved = list(reng.run(ragged, GPTOSS_RAGGED_NEW).values())
    sync(dev)
    t_ragged = time.perf_counter() - t1
    del reng
    torch.cuda.empty_cache()

    gen_, gtoks = serve_generate(params, cfg, gprompts, GPTOSS_GEN_NEW)
    qgen, qtoks = serve_generate(params, cfg, qprompts, GPTOSS_GEN_NEW,
                                 kv_quant="int8")
    for toks, n in zip(served + qserved + rserved,
                       [GPTOSS_NEW] * len(prompts)
                       + [GPTOSS_RAGGED_NEW] * (len(qpaged) + len(ragged))):
        if len(toks) != n or not all(0 <= x < cfg.vocab_size for x in toks):
            raise AssertionError(f"path p: a request answered {toks}")
    return ({"engine_batch_s": t_batch, "engine_ticks": ticks,
             "engine_tok_s": len(prompts) * GPTOSS_NEW / t_batch,
             "int8_pools_engine_s": runs["int8"][0],
             "ragged_engine_s": t_ragged, "kv_bytes": kv_bytes, **gen_,
             "int8_generate_s": qgen["generate_s"],
             "int8_generate_tok_s": qgen["generate_tok_s"]},
            served, qserved, rserved, gtoks, qtoks)


def serve_gptoss_speculative(params, cfg, gprompts, prompts):
    """Path (p)'s speculative part, spec_k 3, with the model's first
    GPTOSS_DRAFT layers (the same tensors) as the draft:
    ``speculative_generate`` over ``gprompts`` (bf16 caches: the verify
    runs the contiguous chunk kernel) and the speculative Engine over an
    int8 contiguous cache serving ``prompts`` (the quantized one). Returns
    timings and the served streams."""
    from leetcuda_tpu_torch.engine import Engine, EngineConfig
    from leetcuda_tpu_torch.engine.speculative import speculative_generate

    dev = params["embed"].device
    dcfg = dataclasses.replace(cfg, n_layers=GPTOSS_DRAFT)
    draft = {**params, "layers": params["layers"][:GPTOSS_DRAFT]}
    t0 = time.perf_counter()
    gtoks, rate = speculative_generate(params, cfg, draft, dcfg, gprompts,
                                       GPTOSS_SPEC_NEW, k=SPEC_K, device=dev)
    sync(dev)
    t_gen = time.perf_counter() - t0
    eng = Engine(params, cfg, EngineConfig(
        slots=len(prompts), max_seq=GPTOSS_MAX_SEQ, prefill_bucket=128,
        kv_quant="int8", spec_k=SPEC_K), draft=(draft, dcfg), device=dev)
    t1 = time.perf_counter()
    served = list(eng.run(prompts, GPTOSS_SPEC_NEW).values())
    sync(dev)
    res = {"generate_s": t_gen, "generate_acceptance_rate": rate,
           "engine_s": time.perf_counter() - t1,
           "engine_acceptance_rate": eng.acceptance_rate}
    for toks in served + gtoks.tolist():
        if len(toks) != GPTOSS_SPEC_NEW or not all(
                0 <= x < cfg.vocab_size for x in toks):
            raise AssertionError(f"path p: a speculative stream {toks}")
    return res, gtoks, served


def combine_ms(params, cfg, flush, batch):
    """Device ms of the dense expert combine (``_gptoss_moe``) of one
    B=``batch`` decode step: each layer's call on a (batch, 1, D) input,
    timed alone with CUDA events, summed over the layers."""
    from leetcuda_tpu_torch.models.llama import _gptoss_moe

    h = torch.randn((batch, 1, cfg.dim), generator=torch.Generator(
        device=params["embed"].device).manual_seed(0),
        device=params["embed"].device).to(cfg.dtype)
    return sum(time_ms(lambda moe=layer["moe_oss"]: _gptoss_moe(h, moe, cfg),
                       flush, iters=5, warmup=1)
               for layer in params["layers"])


def gptoss_path(dev="cuda"):
    """Path (p): GPT-OSS-20B (24 layers, 64 / 8 heads of 64, sinks, a
    128-token window on the even layers, 32 experts of 2880 with 4 active,
    vocab 201088, bf16). Phase 3's ``with_lse`` checks at its layer-0
    shapes first (``check_lse``); then the weights, built on the card from
    a seed (``gptoss_params``); the paged Engine with chunked prefill, a
    ragged admission and ``generate`` over bf16 and int8 caches
    (``serve_gptoss``) with the launch counts zeroed just before and read
    just after: exactly one attention launch per layer per forward, ragged
    forward, chunk and decode step, every one with the lse, half of them
    windowed; served tok/s under the weight-read ceiling (the dense combine
    reads every expert); every served token teacher-forced against a solo
    replay (phase 5) beside the roundoff control; the logits of one prompt
    with and without the sinks; one B=8 decode step at context 1024
    profiled, with the dense combine's device ms (phase 6). Returns (rows
    for the kernels line, the path's report).

    The served router has margins (``margin_router``). As drawn, the
    router's 4th and 5th logits of a token often lie within bf16 roundoff
    of each other; the served and the replayed paths then pick different
    experts, and since the 4th expert's weight is a softmax over four
    logits, not a small tail, the output jumps: two replays that differ
    only in roundoff (``prefill_roundoff_control``) disagree on the argmax
    and no teacher-forced check can tell a fault from roundoff (on an
    H100 80GB HBM3 at 700 W, with 2 layers, served tokens landed up to
    1.23 below the replay's max). The control runs at both routers and is reported."""
    from leetcuda_tpu_torch.engine import generate
    from leetcuda_tpu_torch.models.llama import (forward, gpt_oss_20b_config,
                                                 named_leaves)

    cfg = gpt_oss_20b_config()
    res = {"model": "GPT-OSS-20B",
           "config": {k: (str(v) if isinstance(v, torch.dtype) else v)
                      for k, v in dataclasses.asdict(cfg).items()}}
    t0 = time.perf_counter()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rec = Recorder(dev)
    check_lse(rec, flush, cfg)
    torch.cuda.empty_cache()
    res["phase3_s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    params = gptoss_params(cfg, GPTOSS_SEED, dev)
    sync(params["embed"].device)
    res.update(init_s=time.perf_counter() - t1,
               weight_bytes=param_bytes(params),
               n_params=sum(p.numel() for _, p in named_leaves(params)),
               expert_params=sum(v.numel() for layer in params["layers"]
                                 for k, v in layer["moe_oss"].items()
                                 if k.startswith(("w_", "b_"))))
    # a step reads every weight once (the dense combine reads every expert)
    res["tok_s_ceiling"] = GPTOSS_SLOTS / (res["weight_bytes"]
                                           / HBM_BYTES_PER_S)
    res["generate_tok_s_ceiling"] = GPTOSS_GEN_B / (res["weight_bytes"]
                                                    / HBM_BYTES_PER_S)

    rng = np.random.default_rng(GPTOSS_SEED + 1)
    V = cfg.vocab_size
    control = torch.from_numpy(rng.integers(0, V, (1, 1024)).astype(
        np.int32)).to(dev)
    prompts = [rng.integers(0, V, n).tolist() for n in GPTOSS_PLENS]
    qpaged = [rng.integers(0, V, n).tolist() for n in GPTOSS_QPAGED]
    ragged = [rng.integers(0, V, n).tolist() for n in GPTOSS_RAGGED]
    gprompts = torch.from_numpy(rng.integers(
        0, V, (GPTOSS_GEN_B, GPTOSS_GEN_S)).astype(np.int32)).to(dev)
    qprompts = gprompts[:GPTOSS_Q_B]
    with torch.no_grad():
        res["roundoff_control"] = {"router as drawn": prefill_roundoff_control(
            params, cfg, control)}
        margin_router(params, GPTOSS_SEED + 2)
        res["roundoff_control"]["router with margins"] = (
            prefill_roundoff_control(params, cfg, control))
    generate(params, cfg, gprompts[:1, :16], 2, device=dev)  # warm-up
    calls, kinds = {}, {}

    def serve():
        with model_calls(calls), attention_windows(kinds):
            return serve_gptoss(params, cfg, prompts, qpaged, ragged,
                                gprompts, qprompts)

    (out, served, qserved, rserved, gtoks, qtoks), counts, peak = drive(
        "p", serve)
    res.update(out, launches=counts, model_calls=calls,
               attention_calls=kinds, peak_extra_bytes=peak,
               peak_bytes=torch.cuda.max_memory_allocated())
    n_calls = sum(calls.values())
    attn = sum(counts.get(n, 0) for n in ATTN_COUNTERS)
    with_lse = sum(counts.get(n, 0) for n in LSE_COUNTERS)
    if attn != cfg.n_layers * n_calls or with_lse != attn or any(
            counts.get(n, 0) % cfg.n_layers for n in ATTN_COUNTERS):
        raise AssertionError(f"path p: {attn} attention launches ({with_lse} "
                             f"with the lse) for {calls}, not one with the "
                             f"lse per layer per call "
                             f"({cfg.n_layers * n_calls}): {counts}")
    half = cfg.n_layers // 2 * n_calls
    if kinds != {"local": half, "global": half}:
        raise AssertionError(f"path p: attention calls by layer {kinds}, "
                             f"not {half} windowed and {half} global")
    for what, ceiling in (("engine_tok_s", "tok_s_ceiling"),
                          ("generate_tok_s", "generate_tok_s_ceiling")):
        if res[what] > res[ceiling]:
            raise AssertionError(f"path p: {what} {res[what]:.1f} exceeds "
                                 f"its ceiling {res[ceiling]:.1f}")
    # the speculative part: the draft's calls have 2 layers, so its counts
    # are held apart, every attention launch with the lse
    (spec, stoks, sserved), scounts, _ = drive(
        "p2", lambda: serve_gptoss_speculative(params, cfg,
                                               gprompts[:GPTOSS_SPEC_B],
                                               ragged))
    if sum(scounts.get(n, 0) for n in ATTN_COUNTERS) != sum(
            scounts.get(n, 0) for n in LSE_COUNTERS):
        raise AssertionError(f"path p: a speculative attention launch "
                             f"without the lse: {scounts}")
    res["speculative"] = {**spec, "launches": scounts}

    # phase 5: every served stream against a solo replay; the int8 streams
    # over an int8 cache (a B=1 forward, then decode steps)
    t5 = time.perf_counter()
    gaps = {}
    with torch.no_grad():
        for i, (p, toks) in enumerate(zip(prompts, served)):
            gaps[f"engine/{i}"] = chunk_replay_gap(params, cfg, p, toks)
        for i, (p, toks) in enumerate(zip(ragged, rserved)):
            gaps[f"ragged/{i}"] = chunk_replay_gap(params, cfg, p, toks)
        for b, toks in enumerate(gtoks.tolist()):
            gaps[f"generate/{b}"] = chunk_replay_gap(
                params, cfg, gprompts[b].tolist(), toks)
        for b, toks in enumerate(qtoks.tolist()):
            gaps[f"int8/{b}"] = replay_gap(params, cfg, qprompts[b].tolist(),
                                           toks, "int8")
        for i, (p, toks) in enumerate(zip(qpaged, qserved)):
            gaps[f"int8 pools/{i}"] = replay_gap(params, cfg, p, toks, "int8")
        for b, toks in enumerate(stoks.tolist()):
            gaps[f"speculative/{b}"] = chunk_replay_gap(
                params, cfg, gprompts[b].tolist(), toks)
        for i, (p, toks) in enumerate(zip(ragged, sserved)):
            gaps[f"speculative int8/{i}"] = replay_gap(params, cfg, p, toks,
                                                       "int8")
        res["teacher_forced"] = {"tol": LOGIT_TOL,
                                 "worst": max(gaps.values()), "gaps": gaps,
                                 "seconds": time.perf_counter() - t5}
        # the sinks must bite: the same prompt without them
        lg = forward(params, control[:, :256], cfg)
        nosink = {**params, "layers": [
            {k: v for k, v in layer.items() if k != "sinks"}
            for layer in params["layers"]]}
        res["sinks_dlogit"] = float(
            (forward(nosink, control[:, :256], cfg) - lg).abs().max())
        del lg, nosink
    if res["teacher_forced"]["worst"] > LOGIT_TOL:
        raise AssertionError(f"path p: served tokens off the solo replay: "
                             f"{gaps}")
    if res["sinks_dlogit"] <= LOGIT_TOL:
        raise AssertionError(f"path p: removing the sinks moves the logits "
                             f"by only {res['sinks_dlogit']}")
    res["phase5_s"] = time.perf_counter() - t5

    # phase 6: one B=8 decode step at context 1024, and the dense combine
    res["profile"] = profile_decode(
        params, cfg, batch=8, context=1024,
        classes={"attention": ("decode_attn",),
                 "matmul": ("gemm", "sm90", "nvjet", "cutlass", "cublas")})
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    res["combine_ms_per_step"] = combine_ms(params, cfg, flush, 8)
    return rec.rows, res


def print_gptoss(rows, res):
    c = res["config"]
    for r in rows.values():
        print(f"kernel {r['check']}: lse max_abs_err {r['max_abs_err']:.3g} "
              f"out {r['out_max_abs_err']:.3g} kernel {r['ms']:.4f} ms "
              f"(without the lse {r['ms_without_lse']:.4f}) plain "
              f"{r['plain_ms']:.4f} ms library {r['library_ms']:.4f} ms "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); controls "
              f"{r['lse_controls']}", flush=True)
    print(f"path (p) {res['model']} ({c['n_layers']} layers, "
          f"{res['n_params'] / 1e9:.2f}B params, "
          f"{res['expert_params'] / 1e9:.2f}B in experts, sinks, window "
          f"{c['sliding_window']} on even layers, bf16, random weights built "
          f"in {res['init_s']:.1f} s): paged Engine, prefill_chunk "
          f"{GPTOSS_CHUNK}, {len(GPTOSS_PLENS)} requests (prompts "
          f"{list(GPTOSS_PLENS)}) x {GPTOSS_NEW} tokens in "
          f"{res['engine_batch_s']:.3f} s = {res['engine_tok_s']:.2f} tok/s "
          f"({res['engine_ticks']} ticks; ceiling "
          f"{res['tok_s_ceiling']:.2f}); ragged admission "
          f"{list(GPTOSS_RAGGED)} x {GPTOSS_RAGGED_NEW}: "
          f"{res['ragged_engine_s']:.3f} s; generate B={GPTOSS_GEN_B} "
          f"S={GPTOSS_GEN_S} x {GPTOSS_GEN_NEW}: {res['generate_s']:.3f} s = "
          f"{res['generate_tok_s']:.2f} tok/s (ceiling "
          f"{res['generate_tok_s_ceiling']:.2f}); int8 KV B={GPTOSS_Q_B}: "
          f"{res['int8_generate_s']:.3f} s = "
          f"{res['int8_generate_tok_s']:.2f} tok/s; paged Engine over int8 "
          f"pools {list(GPTOSS_QPAGED)} x {GPTOSS_RAGGED_NEW}: "
          f"{res['int8_pools_engine_s']:.3f} s; params "
          f"{res['weight_bytes'] / 2**30:.2f} GiB, pool "
          f"{res['kv_bytes'] / 2**30:.2f} GiB, peak device memory "
          f"{res['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    print(f"  model calls {res['model_calls']}; attention calls by layer "
          f"{res['attention_calls']}; launches: {res['launches']}")
    sp = res["speculative"]
    print(f"  speculative, spec_k {SPEC_K}, a {GPTOSS_DRAFT}-layer draft: "
          f"speculative_generate B={GPTOSS_SPEC_B} x {GPTOSS_SPEC_NEW} in "
          f"{sp['generate_s']:.3f} s (acceptance "
          f"{sp['generate_acceptance_rate']:.3f}); Engine over int8 "
          f"{list(GPTOSS_RAGGED)} x {GPTOSS_SPEC_NEW} in {sp['engine_s']:.3f} "
          f"s (acceptance {sp['engine_acceptance_rate']:.3f}); launches "
          f"{ {k: v for k, v in sp['launches'].items() if v} }")
    tf = res["teacher_forced"]
    print(f"  teacher-forced: worst gap {tf['worst']:.4f} (tol {tf['tol']}) "
          f"over {len(tf['gaps'])} streams in {tf['seconds']:.1f} s; "
          f"roundoff control (forward against decode_chunk, 1024 tokens): "
          f"{res['roundoff_control']}; without the sinks the logits move by "
          f"{res['sinks_dlogit']:.4f}")
    prof = res["profile"]
    print_profile("(p) GPT-OSS-20B, contiguous bf16 cache", prof)
    dev_ms = prof["device_ms_per_step"]
    print(f"  dense combine {res['combine_ms_per_step']:.3f} ms a step "
          f"(timed alone) of {dev_ms:.3f} device ms; device ms by class "
          f"{prof['device_ms_by_class']}", flush=True)


# Path (q), DeepSeek-V2-Lite (``deepseek_v2_lite_config``: 27 layers, hidden
# 2048, 16 heads, MLA with a 512 + 64 latent, 64 routed experts of 1408 with
# 6 active and 2 shared, vocab 102400, bf16): its phase 3 (``check_shared``)
# at its layer shapes, then ``mla_generate`` B=8 S=128 over a bf16 latent
# cache and the decode step over int8 / e4m3 latent caches and paged bf16 /
# int8 pools (pages of MLA_PAGE, a PageManager with a shuffled free list),
# every stream MLA_NEW tokens.
MLA_SEED = 11
MLA_B, MLA_S, MLA_NEW = 8, 128, 32
MLA_PAGE = 16
MLA_CONTROL_LEN = 128  # the roundoff control's prompt: prefill vs decode
# phase 3 of path (q): B=8 rows of DECODE_LENS at H=16; DeepSeek-V2/V3's
# 128 heads over one latent at B=2; the group of 7 (Qwen2.5-7B's 28 / 4
# heads of 128) of an unshared cache; capacity 2048
MLA_WIDE_H, MLA_WIDE_LENS = 128, np.array([1950, 517], np.int32)
GROUP7 = (28, 4, 128)
MLA_CAP, MLA_WINDOW = 30.0, 1000  # the options' check (q at CAP_Q_SCALE)


def shared_case(rec, flush, check, name, replaces, fn, plain, args, kw,
                flops, nbytes, lib, sm_scale):
    """One shared-KV check: the kernel against its plain version (every
    output lane; NaN padding must not reach it), timed beside the plain
    version and ``lib``; then the scale control: the plain version at the
    wrapper's default scale 1 / sqrt(D) must fail KERNEL_TOL against the
    kernel's output at ``sm_scale``."""
    q = args[0]
    kw = {**kw, "sm_scale": sm_scale, "shared_kv": True}
    got = fn(*args, **kw)
    out = got[0] if isinstance(got, tuple) else got
    if not torch.isfinite(out).all():
        raise AssertionError(f"{check}: NaN padding reached the output")
    want = plain(*args, **kw)
    out_err = None
    if isinstance(got, tuple):  # with the lse: hold the output, record the lse
        out_err = hold(got[0], want[0])
        got, want = got[1], want[1]
    rec.record(check, name, DECODE_SRC, replaces, got, want,
               time_ms(lambda: fn(*args, **kw), flush),
               time_ms(lambda: plain(*args, **kw), flush, iters=5),
               time_ms(lib, flush), flops, nbytes,
               rate=PEAK_RATE[q.dtype])
    if out_err is not None:
        rec.rows[check]["out_max_abs_err"] = out_err
    ctl = plain(*args, **{**kw, "sm_scale": None})
    ctl = ctl[1] if isinstance(ctl, tuple) else ctl
    err = float((ctl.float() - got.float()).abs().max())
    if torch.allclose(ctl.float(), got.float(), **KERNEL_TOL):
        raise AssertionError(f"{check}: the plain version at the default "
                             f"scale passes the check")
    rec.rows[check]["scale_control"] = err


def check_shared(rec, flush, cfg):
    """Phase 3 of path (q): the shared-KV decode and paged kernels at
    DeepSeek-V2-Lite's shapes: one latent head of ``cfg.latent_dim`` = 576
    lanes under H = 16 query heads at B=8 (lengths 1..2000, capacity 2048)
    over a bf16 cache and, with an f32 query, int8 and e4m3 ones; paged over
    shuffled pages of 128 and 16; H = 128 at B = 2 (bf16 and int8, paged
    bf16); one bf16 case with a window, a softcap and the lse. NaN past
    every length and in every position no row owns (e4m3: the NaN byte;
    the quantized caches: NaN scales). Each at MLA's scale 1 / sqrt(192),
    every one of the 576 output lanes against the plain version, beside the
    scale control (``shared_case``), the bound (the latent read ONCE, for
    K and V; the f32 queries' products at the f32 rate) and SDPA over the
    latent as K and V, expanded to the H heads. Then one unshared case at a
    GQA group of 7 (the head blocks of the wide kernel)."""
    from leetcuda_tpu_torch.attention import decode as dec
    from leetcuda_tpu_torch.attention import paged as pg
    from leetcuda_tpu_torch.core.runtime import as_bytes
    from leetcuda_tpu_torch.models.mla import _quantize_latent

    dev, bf = rec.dev, torch.bfloat16
    L, S = cfg.latent_dim, 2048
    sm = 1.0 / math.sqrt(cfg.qk_head_dim)
    fills = {"bf16": float("nan"), "int8": 0, "fp8": 0x7F}
    for H, lens_np in ((cfg.n_heads, DECODE_LENS), (MLA_WIDE_H,
                                                    MLA_WIDE_LENS)):
        B = len(lens_np)
        lengths = torch.from_numpy(lens_np).to(dev)
        cols = torch.arange(S, device=dev)[None, :]
        past = (cols >= lengths[:, None])[:, None, :]          # (B, 1, S)
        mask = ~past[:, :, None, :]                            # (B,1,1,S)
        n_att = int(lens_np.sum())
        q_bf = rec.randn(B, H, L)
        q_f32 = torch.from_numpy(rec.rng.standard_normal(
            (B, H, L), dtype=np.float32)).to(dev)
        lat = rec.randn(B, 1, S, L)
        caches = {}
        for fmt in ("bf16", "int8", "fp8"):
            if fmt == "bf16":
                c = lat.clone()
                c[past[..., None].expand_as(c)] = float("nan")
                caches[fmt] = ([c], lat, q_bf)
                continue
            rows, s = _quantize_latent(lat, fmt)
            deq = (rows.float() * s[..., None]).to(bf)
            s[past] = float("nan")
            as_bytes(rows)[past[..., None].expand_as(rows)] = fills[fmt]
            caches[fmt] = ([rows, s], deq, q_f32)
        wide = H != cfg.n_heads
        for fmt, (tensors, deq, q) in caches.items():
            if wide and fmt == "fp8":
                continue
            elt = 2 if fmt == "bf16" else 1
            qo_bytes = 2.0 * q.numel() * q.element_size()
            nbytes = (elt * L * n_att + (4.0 * n_att if elt == 1 else 0.0)
                      + qo_bytes + 4 * B)
            lib = (lambda deq=deq, q=q: sdpa(q.to(bf)[:, :, None], deq, deq,
                                             attn_mask=mask, scale=sm))
            pages = (None, PAGE, 16) if not wide else (
                (None, PAGE) if fmt == "bf16" else (None,))
            for page in pages:
                extra, args = 0.0, (q, *tensors, lengths)
                if page is None:
                    fn, plain = ((dec.decode_attention,
                                  dec.decode_attention_plain)
                                 if fmt == "bf16" else
                                 (dec.decode_attention_quantized,
                                  dec.decode_attention_quantized_plain))
                    replaces = ("leetcuda_tpu/attention/decode.py:"
                                + ("223" if fmt == "bf16" else "308"))
                else:
                    n_pages = -(-lens_np // page)
                    table, owned = shuffled_table(rec.rng, n_pages,
                                                  S // page, dev)
                    pools = [to_pool(t, page, table, owned,
                                     fills[fmt] if t.dim() == 4
                                     else float("nan")) for t in tensors]
                    args = (q, *pools, table, lengths)
                    extra = 4.0 * int(n_pages.sum())
                    fn, plain = ((pg.paged_attention,
                                  pg.paged_attention_plain)
                                 if fmt == "bf16" else
                                 (pg.paged_attention_quantized,
                                  pg.paged_attention_quantized_plain))
                    replaces = "leetcuda_tpu/attention/paged.py:232"
                name = fn.__name__ + "_shared"
                check = (f"(q) {name}/{fmt} B={B} H={H}"
                         + (f" page{page}" if page else ""))
                shared_case(rec, flush, check, name, replaces, fn, plain,
                            args, {}, 4.0 * H * L * n_att, nbytes + extra,
                            lib, sm)
                rec.rows[check].update(lengths=lens_np.tolist(), H=H,
                                       head_dim=L, q_dtype=str(q.dtype))
        if wide:
            continue
        # the options: a window, a softcap (q at CAP_Q_SCALE) and the lse
        c, _, q = caches["bf16"]
        q10 = (q.float() * CAP_Q_SCALE).to(bf)
        kw = {"window": MLA_WINDOW, "softcap": MLA_CAP, "with_lse": True}
        band = mask & (cols >= lengths[:, None] - MLA_WINDOW)[:, None, None]
        n_band = int(band.sum())
        check = f"(q) decode_attention_shared/bf16 W{MLA_WINDOW} cap{MLA_CAP:g}"
        shared_case(rec, flush, check, "decode_attention_shared",
                    "leetcuda_tpu/attention/decode.py:223",
                    dec.decode_attention, dec.decode_attention_plain,
                    (q10, c[0], lengths), kw, 4.0 * H * L * n_band,
                    2.0 * L * n_band + 4.0 * q10.numel() + 4.0 * B * H
                    + 4 * B,
                    lambda: sdpa(q10[:, :, None], lat, lat, attn_mask=band,
                                 scale=sm), sm)
        rec.rows[check].update(lengths=lens_np.tolist(), **{
            k: v for k, v in kw.items() if k != "with_lse"})
        del caches, lat, c

    # an unshared cache at a GQA group of 7: the wide kernel's head blocks
    H, Hkv, D = GROUP7
    lens_np = DECODE_LENS
    B = len(lens_np)
    lengths = torch.from_numpy(lens_np).to(dev)
    past = (torch.arange(S, device=dev)[None, :] >= lengths[:, None])
    q, kc, vc = (rec.randn(B, H, D), rec.randn(B, Hkv, S, D),
                 rec.randn(B, Hkv, S, D))
    k0, v0 = kc.clone(), vc.clone()
    kc[past[:, None, :].expand(B, Hkv, S)] = float("nan")
    vc[past[:, None, :].expand(B, Hkv, S)] = float("nan")
    args = (q, kc, vc, lengths)
    got = dec.decode_attention(*args)
    if not torch.isfinite(got).all():
        raise AssertionError("group 7: NaN padding reached the output")
    n_att = int(lens_np.sum())
    rec.record(f"(q) decode_attention/group 7 ({H} / {Hkv} heads of {D})",
               "decode_attention", DECODE_SRC,
               "leetcuda_tpu/attention/decode.py:223", got,
               dec.decode_attention_plain(*args),
               time_ms(lambda: dec.decode_attention(*args), flush),
               time_ms(lambda: dec.decode_attention_plain(*args), flush,
                       iters=5),
               time_ms(lambda: sdpa(q[:, :, None], k0, v0,
                                    attn_mask=~past[:, None, None, :]),
                       flush),
               4.0 * H * D * n_att,
               2.0 * (2 * Hkv * n_att * D + 2 * B * H * D) + 4 * B)


def mla_replay_gap(params, cfg, prompt, tokens):
    """Teacher-forced gap of ``tokens`` served after ``prompt``: one solo
    B=1 ``mla_model_prefill`` over prompt + tokens (the expanded form, no
    kernel); the largest (max logit - logit of the served token) over the
    served positions. It holds the absorbed decode against the expanded
    attention at full depth."""
    from leetcuda_tpu_torch.models.mla import mla_model_prefill

    dev = params["embed"].device
    seq = torch.tensor([list(prompt) + list(tokens)[:-1]], dtype=torch.int32,
                       device=dev)
    logits, _ = mla_model_prefill(params, seq, cfg)
    rows = logits[0, len(prompt) - 1:]
    tgt = torch.tensor(list(tokens), dtype=torch.long, device=dev)
    return float((rows.max(-1).values
                  - rows.gather(1, tgt[:, None])[:, 0]).max())


def mla_cache_replay_gap(params, cfg, prompt, tokens, quant):
    """The same gap over a solo replay with the served stream's cache type:
    a B=1 ``mla_model_prefill`` over the prompt, its latent caches
    quantized (``_quantize_latent``, ``quant`` "int8" | "fp8"), then one
    B=1 ``mla_model_decode_step`` per served token. What the quantized
    latent costs shows as this gap's distance from ``mla_replay_gap``'s."""
    from leetcuda_tpu_torch.models.mla import (_quantize_latent,
                                               mla_model_decode_step,
                                               mla_model_prefill)

    dev = params["embed"].device
    L, n = len(prompt), len(tokens)
    lg, caches = mla_model_prefill(params, torch.tensor(
        [list(prompt)], dtype=torch.int32, device=dev), cfg, max_seq=L + n)
    caches = [_quantize_latent(c, quant) for c in caches]
    toks = torch.tensor(list(tokens), dtype=torch.int32, device=dev)
    gaps = [lg[0, L - 1].max() - lg[0, L - 1, toks[0].long()]]
    lengths = torch.full((1,), L, dtype=torch.int32, device=dev)
    for j in range(n - 1):
        lg, caches = mla_model_decode_step(params, toks[j:j + 1], caches,
                                           lengths, cfg)
        lengths += 1
        gaps.append(lg[0].max() - lg[0, toks[j + 1].long()])
    return float(torch.stack(gaps).max())


def mla_roundoff_control(params, cfg, toks):
    """Two solo replays of ``toks`` (1, N) that differ only in roundoff:
    ``mla_model_prefill`` over all of it, and over its first half followed
    by teacher-forced ``mla_model_decode_step``s (the absorbed form through
    the shared kernel). Their largest |logit difference|, top-1 agreement
    and worst gap (the decode replay's max logit over its logit of the
    prefill's argmax) over the second half: the floor under the
    teacher-forced gaps, route flips of the router included."""
    from leetcuda_tpu_torch.models.mla import (mla_model_decode_step,
                                               mla_model_prefill)

    N = toks.shape[1]
    h = N // 2
    a = mla_model_prefill(params, toks, cfg)[0][0, h - 1:N - 1]
    lg, caches = mla_model_prefill(params, toks[:, :h], cfg, max_seq=N)
    rows = [lg[0, h - 1]]
    lengths = torch.full((1,), h, dtype=torch.int32, device=toks.device)
    for i in range(h, N - 1):
        lg, caches = mla_model_decode_step(params, toks[:, i], caches,
                                           lengths, cfg)
        rows.append(lg[0])
        lengths += 1
    b = torch.stack(rows)
    top = a.argmax(-1)
    return {"max_abs_dlogit": float((a - b).abs().max()),
            "top1": float((top == b.argmax(-1)).float().mean()),
            "worst_gap": float((b.max(-1).values
                                - b.gather(1, top[:, None])[:, 0]).max())}


def mla_stream(params, cfg, first, caches, lengths, n, page_table=None):
    """``n`` greedy tokens: ``first``, then n - 1 ``mla_model_decode_step``s
    from ``lengths`` over ``caches`` (pools behind ``page_table``)."""
    from leetcuda_tpu_torch.models.mla import mla_model_decode_step

    tok, out = first, [first]
    for _ in range(n - 1):
        lg, caches = mla_model_decode_step(params, tok, caches, lengths, cfg,
                                           page_table=page_table)
        tok = lg.argmax(-1).to(torch.int32)
        lengths = lengths + 1
        out.append(tok)
    return torch.stack(out, 1)


def serve_mla(params, cfg, prompts):
    """Path (q)'s serving over ``prompts`` (B, S): ``mla_generate`` (bf16
    latent cache); the prefill's caches quantized (``_quantize_latent``)
    into int8 and e4m3 latent caches and decoded; the same caches moved
    into paged bf16 and int8 pools (pages of MLA_PAGE from a PageManager
    whose free list is shuffled) and decoded. Returns timings, launches
    expected of each entry point and the served streams by cache."""
    from leetcuda_tpu_torch.attention.paged import PageManager
    from leetcuda_tpu_torch.models.mla import (_quantize_latent,
                                               init_paged_latent_cache,
                                               mla_generate,
                                               mla_model_prefill)

    dev = params["embed"].device
    B, S = prompts.shape
    n, cap = MLA_NEW, S + MLA_NEW
    cap += -cap % MLA_PAGE
    res, streams = {}, {}
    t0 = time.perf_counter()
    streams["bf16"] = mla_generate(params, cfg, prompts, n)
    sync(dev)
    res["generate_s"] = time.perf_counter() - t0
    res["generate_tok_s"] = B * n / res["generate_s"]

    t0 = time.perf_counter()
    logits, caches = mla_model_prefill(params, prompts, cfg, max_seq=cap)
    first = logits[:, S - 1].argmax(-1).to(torch.int32)
    del logits
    sync(dev)
    res["prefill_s"] = time.perf_counter() - t0
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    pm = PageManager(B * cap // MLA_PAGE + 1, MLA_PAGE, cap // MLA_PAGE, B)
    np.random.default_rng(MLA_SEED + 3).shuffle(pm.free)
    for slot in range(B):
        if not pm.ensure(slot, cap - 1):
            raise AssertionError("path q: the page pool is too small")
    table = pm.device_table(dev)
    owned = torch.ones(table.shape, dtype=torch.bool, device=dev)
    n_pages = pm.table.size + 1
    for quant in ("int8", "fp8", "paged bf16", "paged int8"):
        if quant == "paged bf16":
            cs = [to_pool(c, MLA_PAGE, table, owned, 0.0) for c in caches]
        else:
            qz = [_quantize_latent(c, "int8" if "int8" in quant else "fp8")
                  for c in caches]
            cs = qz if not quant.startswith("paged") else [
                (to_pool(r, MLA_PAGE, table, owned, 0),
                 to_pool(s, MLA_PAGE, table, owned, 1.0)) for r, s in qz]
            del qz
        sync(dev)
        t0 = time.perf_counter()
        streams[quant] = mla_stream(
            params, cfg, first, cs, lengths, n,
            page_table=table if quant.startswith("paged") else None)
        sync(dev)
        res[f"{quant}_decode_s"] = time.perf_counter() - t0
        res[f"{quant}_tok_s"] = B * (n - 1) / res[f"{quant}_decode_s"]
        del cs
    del caches
    for name, toks in streams.items():
        if tuple(toks.shape) != (B, n) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"path q: {name} stream {toks}")
    steps = cfg.n_layers * (n - 1)
    expect = {"decode_attention_shared": steps,
              "decode_attention_quantized_shared": 2 * steps,
              "paged_attention_shared": steps,
              "paged_attention_quantized_shared": steps}
    res["page_size"], res["pool_pages"] = MLA_PAGE, n_pages
    res["latent_cache_bytes"] = cfg.n_layers * B * cap * cfg.latent_dim * 2
    return res, expect, streams


def profile_mla_decode(params, cfg, batch, context, steps=8):
    """Phase 6 of path (q): one B=``batch`` absorbed decode step at
    ``context`` over bf16 latent caches (``profile_run``), the shared
    decode kernels' device ms apart (class "attention")."""
    from leetcuda_tpu_torch.models.mla import mla_model_decode_step

    dev = params["embed"].device
    capacity = context + 2 * steps
    capacity += -capacity % 1024
    caches = [torch.zeros((batch, 1, capacity, cfg.latent_dim),
                          dtype=cfg.dtype, device=dev)
              for _ in range(cfg.n_layers)]
    tok = torch.zeros(batch, dtype=torch.int32, device=dev)

    def run():
        lengths = torch.full((batch,), context, dtype=torch.int32,
                             device=dev)
        for _ in range(steps):
            mla_model_decode_step(params, tok, caches, lengths, cfg)
            lengths += 1
        sync(dev)

    return {"batch": batch, "context": context, "kv_quant": None,
            "paged": False, **profile_run(
                run, steps, {"attention": ("decode_attn",),
                             "matmul": ("gemm", "sm90", "nvjet", "cutlass",
                                        "cublas")})}


def mla_combine_ms(params, cfg, flush, batch):
    """Device ms of DeepSeek MoE's dense combine (``_deepseek_moe``, shared
    experts included) in one B=``batch`` decode step: each MoE layer's call
    on a (batch, D) input, timed alone with CUDA events, summed."""
    from leetcuda_tpu_torch.models.mla import _deepseek_moe

    dev = params["embed"].device
    h = torch.randn((batch, cfg.dim), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev).to(cfg.dtype)
    return sum(time_ms(lambda moe=layer["moe"]: _deepseek_moe(h, moe, cfg),
                       flush, iters=5, warmup=1)
               for layer in params["layers"] if "moe" in layer)


def mla_path(dev="cuda"):
    """Path (q): DeepSeek-V2-Lite (``deepseek_v2_lite_config``, 27 layers,
    15.7B random bf16 parameters built on the card from a seed, the untied
    head included). Phase 3's shared-KV checks at its shapes first
    (``check_shared``); then the weights; a roundoff control (prefill
    against stepwise decode on one prompt); the serving (``serve_mla``)
    with the launch counts zeroed just before and read just after: exactly
    one shared launch per layer per decode step, on the entry point of the
    step's cache, and no flash, gmm, fused entry or unshared attention
    launch; every served token teacher-forced against a solo prefill
    replay (phase 5); one B=8 decode step at context 1024 profiled, with the
    dense combine timed alone (phase 6). Returns (rows for the kernels
    line, the path's report)."""
    from leetcuda_tpu_torch.models.llama import named_leaves
    from leetcuda_tpu_torch.models.mla import (deepseek_v2_lite_config,
                                               init_mla_model)

    cfg = deepseek_v2_lite_config()
    res = {"model": "DeepSeek-V2-Lite",
           "config": {k: (str(v) if isinstance(v, torch.dtype) else v)
                      for k, v in dataclasses.asdict(cfg).items()}}
    t0 = time.perf_counter()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rec = Recorder(dev)
    check_shared(rec, flush, cfg)
    torch.cuda.empty_cache()
    res["phase3_s"] = time.perf_counter() - t0

    t1 = time.perf_counter()
    params = init_mla_model(torch.Generator(device=dev).manual_seed(MLA_SEED),
                            cfg, device=dev, untied_head=True)
    sync(params["embed"].device)
    res.update(init_s=time.perf_counter() - t1,
               weight_bytes=param_bytes(params),
               n_params=sum(p.numel() for _, p in named_leaves(params)),
               expert_params=sum(
                   p.numel() for layer in params["layers"] if "moe" in layer
                   for k, p in named_leaves(layer["moe"]) if k != "gate_w"))
    # a step reads every weight (the dense combine reads every expert)
    res["tok_s_ceiling"] = MLA_B / (res["weight_bytes"] / HBM_BYTES_PER_S)
    rng = np.random.default_rng(MLA_SEED + 1)
    V = cfg.vocab_size
    control = torch.from_numpy(rng.integers(
        0, V, (1, MLA_CONTROL_LEN)).astype(np.int32)).to(dev)
    prompts = torch.from_numpy(rng.integers(
        0, V, (MLA_B, MLA_S)).astype(np.int32)).to(dev)
    with torch.no_grad():
        t2 = time.perf_counter()
        res["roundoff_control"] = {"router as drawn": mla_roundoff_control(
            params, cfg, control)}
        res["roundoff_control_s"] = time.perf_counter() - t2
        (out, expect, streams), counts, peak = drive(
            "q", lambda: serve_mla(params, cfg, prompts))
    res.update(out, launches=counts, expected_launches=expect,
               peak_extra_bytes=peak,
               peak_bytes=torch.cuda.max_memory_allocated())
    got = {k: counts.get(k, 0) for k in expect}
    if got != expect:
        raise AssertionError(f"path q: shared launches {got}, not one per "
                             f"layer per decode step {expect}")
    if res["generate_tok_s"] > res["tok_s_ceiling"]:
        raise AssertionError(f"path q: generate {res['generate_tok_s']:.1f} "
                             f"tok/s exceeds its ceiling "
                             f"{res['tok_s_ceiling']:.1f}")

    # phase 5: every served token against a solo prefill replay
    t5 = time.perf_counter()
    gaps = {}
    with torch.no_grad():
        for name, toks in streams.items():
            for b, row in enumerate(toks.tolist()):
                gaps[f"{name}/{b}"] = mla_replay_gap(
                    params, cfg, prompts[b].tolist(), row)
        # the contiguous quantized streams also against a replay over their
        # own cache type (reported: the latent's quantization apart)
        same = {f"{name}/{b}": mla_cache_replay_gap(
            params, cfg, prompts[b].tolist(), row, name)
            for name in ("int8", "fp8")
            for b, row in enumerate(streams[name].tolist())}
    worst = {name: max(g for k, g in gaps.items()
                       if k.rsplit("/", 1)[0] == name) for name in streams}
    res["teacher_forced"] = {
        "tol": LOGIT_TOL, "worst": worst, "gaps": gaps,
        "same_cache_worst": {q: max(g for k, g in same.items()
                                    if k.startswith(q + "/"))
                             for q in ("int8", "fp8")},
        "same_cache_gaps": same, "seconds": time.perf_counter() - t5}
    if max(worst.values()) > LOGIT_TOL:
        raise AssertionError(f"path q: served tokens off the solo replay: "
                             f"{gaps}")

    # phase 6: one B=8 decode step at context 1024, the dense combine alone
    with torch.no_grad():
        res["profile"] = profile_mla_decode(params, cfg, batch=MLA_B,
                                            context=1024)
        res["combine_ms_per_step"] = mla_combine_ms(params, cfg, flush,
                                                    MLA_B)
    return rec.rows, res


def print_mla(rows, res):
    c = res["config"]
    for r in rows.values():
        extra = (f" out {r['out_max_abs_err']:.3g}"
                 if "out_max_abs_err" in r else "")
        ctl = (f"; scale control (1/sqrt(576), must fail) "
               f"{r['scale_control']:.3g}" if "scale_control" in r else "")
        print(f"kernel {r['check']}: max_abs_err {r['max_abs_err']:.3g}"
              f"{extra} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} "
              f"ms library {r['library_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}){ctl}", flush=True)
    print(f"path (q) {res['model']} ({c['n_layers']} layers, "
          f"{res['n_params'] / 1e9:.2f}B params, "
          f"{res['expert_params'] / 1e9:.2f}B in experts, latent "
          f"{c['kv_lora_rank']} + {c['qk_rope_head_dim']}, bf16, random "
          f"weights built in {res['init_s']:.1f} s): mla_generate B={MLA_B} "
          f"S={MLA_S} x {MLA_NEW}: {res['generate_s']:.3f} s = "
          f"{res['generate_tok_s']:.2f} tok/s (ceiling "
          f"{res['tok_s_ceiling']:.2f}); prefill {res['prefill_s']:.3f} s; "
          f"decode over int8 {res['int8_tok_s']:.2f}, e4m3 "
          f"{res['fp8_tok_s']:.2f}, paged bf16 {res['paged bf16_tok_s']:.2f}"
          f", paged int8 {res['paged int8_tok_s']:.2f} tok/s (pages of "
          f"{res['page_size']}); params {res['weight_bytes'] / 2**30:.2f} "
          f"GiB, peak device memory {res['peak_bytes'] / 2**30:.2f} GiB",
          flush=True)
    print(f"  launches: { {k: v for k, v in res['launches'].items() if v} }")
    tf = res["teacher_forced"]
    print(f"  teacher-forced (solo prefill replays): worst gap by cache "
          f"{tf['worst']} (tol {tf['tol']}) over {len(tf['gaps'])} streams "
          f"(against replays over their own cache type: "
          f"{tf['same_cache_worst']}) in {tf['seconds']:.1f} s; roundoff "
          f"control (prefill against "
          f"stepwise decode, {MLA_CONTROL_LEN} tokens): "
          f"{res['roundoff_control']}")
    prof = res["profile"]
    print_profile("(q) DeepSeek-V2-Lite, bf16 latent cache", prof)
    print(f"  dense combine {res['combine_ms_per_step']:.3f} ms a step "
          f"(timed alone) of {prof['device_ms_per_step']:.3f} device ms; "
          f"device ms by class {prof['device_ms_by_class']}", flush=True)


# Path (t), the parallel layer: 8 ranks on one card, as JAX's test
# mesh is 8 virtual devices on one CPU. First the ring kernels (rows 36-37,
# csrc/ring_p2p.cu) against their plain versions bit for bit, uncounted
# (``check_ring``): 2, 3 and 8 ranks of random bytes (e4m3's NaN bytes 0x7F
# and 0xFF among them) viewed as f32, bf16, int8 and e4m3, shards of
# PAR_SMALL (7 x 13 elements: 91-364 bytes a rank, no multiple of 16; 256 x
# 1024: 0.25-1 MiB), every rank's result and input checked; then timed at 8
# ranks over Qwen3-30B-A3B's K shard at its context over 8 ranks and over
# PAR_BIG bytes a rank, where a launch too large to stay resident must be
# refused and a ring whose waits have no spin budget must raise; and the
# attention kernels at the main path's shapes against their plain versions
# (``check_parallel_attn``). Then the main path (``parallel_main``),
# counted:
# the sequence-sharded K and V of Qwen3-30B-A3B's layer at context PAR_N
# through ``ppermute_p2p`` and ``ring_all_gather_p2p`` (the result against
# the known answer), ``collectives.run_all`` over 8 ranks,
# ``ring_attention`` over sp = 8 and ``ulysses_attention`` over sp = 4 at
# Qwen3-30B-A3B's attention width (32 / 4 heads of 128, B=1, N=32768,
# causal and not) against the single-device flash kernel, the
# context-parallel decode over sp = 8 and dp = 2 x sp = 4 against the
# single-device decode kernel (lengths PAR_DECODE_LENS leave whole ranks
# empty; NaN past every length), and ``pipeline_forward`` of the default
# ModelConfig() at pp = 4, M = 4, B=8, S=2048 against ``forward``. Each
# distributed attention holds every row's relative L2 under PAR_REL_L2
# beside controls that must miss it (``attn_pair``).
RING_SRC = "leetcuda_tpu_torch/csrc/ring_p2p.cu"
RING_REPLACES = {
    "ppermute_p2p": "leetcuda_tpu/parallel/ring_pallas.py:44",
    "ring_all_gather_p2p": "leetcuda_tpu/parallel/ring_pallas.py:105"}
PAR_SEED = 15
PAR_RANKS = (2, 3, 8)
PAR_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8, "e4m3": torch.float8_e4m3fn}
PAR_SMALL = ((7, 13), (256, 1024))
PAR_BIG = 64 << 20
PAR_N = 32768  # Qwen3-30B-A3B's max_position_embeddings
PAR_SP, PAR_ULYSSES_SP = 8, 4
PAR_DECODE_LENS = np.array([1, 100, 4095, 4097, 10000, 20000, 30000, 32768],
                           np.int32)
PAR_PP, PAR_PP_M, PAR_PP_B, PAR_PP_S = 4, 4, 8, 2048
PAR_REL_L2 = 1e-2  # a distributed attention against one device's, each row
PAR_HELD_ROWS = 2048  # query rows of the Ulysses call held against plain
PAR_TIMED_RANKS = {"sp=8": (0, 2), "dp=2 x sp=4": (1, 3)}  # (dp, sp) rank
PATH_KERNELS["t"] = ("ppermute_p2p", "ring_all_gather_p2p",
                     "flash_attention", "flash_attention_lse",
                     "decode_attention_lse")


def as_u8(t):
    """A tensor's bytes, flat."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def rank_shards(gen, n, shape, dtype, dev):
    """n shards of ``shape`` and ``dtype`` made of random bytes, e4m3's NaN
    bytes 0x7F and 0xFF among them, each its own allocation."""
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    out = []
    for _ in range(n):
        b = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, device=dev,
                          generator=gen)
        b[::61] = 0x7F
        b[29::61] = 0xFF
        out.append(b.view(dtype).reshape(shape))
    return out


def same_bytes(what, got, want):
    for r, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(as_u8(g), as_u8(w)):
            raise AssertionError(f"{what}: rank {r}'s result differs from "
                                 f"the plain version")


def ring_case(shards, what):
    """Both kernels against their plain versions, every rank's result bit
    for bit, every input unchanged."""
    from leetcuda_tpu_torch.parallel import ring_p2p as rp

    before = [as_u8(s).clone() for s in shards]
    same_bytes(f"ppermute_p2p {what}", rp.ppermute_p2p_shards(shards),
               rp.ppermute_plain(shards))
    same_bytes(f"ring_all_gather_p2p {what}",
               rp.ring_all_gather_p2p_shards(shards),
               rp.ring_all_gather_plain(shards))
    same_bytes(f"{what} inputs", shards, before)


def ring_rows(rec, flush, label, shards):
    """Rows of both kernels at ``shards`` (8 ranks): the launch alone timed,
    into buffers allocated once (the all-gather's flags zeroed before each
    window, outside it), beside the plain and library times; bounds 2 n C
    (permute) and n C + n^2 C (all-gather). Then the all-gather's fault
    checks: one CTA a rank more than the card holds resident is refused at
    launch, and waits with no spin budget set the error word."""
    from leetcuda_tpu_torch.core.runtime import KernelLaunchError
    from leetcuda_tpu_torch.parallel import ring_p2p as rp

    n, C = len(shards), as_u8(shards[0]).numel()
    ring_case(shards, label)
    stacked = torch.stack([as_u8(s) for s in shards])  # (n, C) bytes
    name = "ppermute_p2p"
    out = [torch.empty_like(s) for s in shards]
    ms = time_ms(lambda: rp._ppermute_into(shards, out), flush)
    want = rp.ppermute_plain(shards)
    same_bytes(f"{name} {label} (timed)", out, want)
    rec.record(f"{name} {label}", name, RING_SRC, RING_REPLACES[name],
               torch.cat([as_u8(g) for g in out]),
               torch.cat([as_u8(w) for w in want]), ms,
               time_ms(lambda: rp.ppermute_plain(shards), flush, iters=5),
               time_ms(lambda: torch.roll(stacked, 1, 0), flush),
               0, 2 * n * C)
    name = "ring_all_gather_p2p"
    out, comm, flags = rp.ring_workspace(shards)
    ms = time_ms(lambda: rp._ring_all_gather_into(shards, out, comm, flags),
                 flush, prep=lambda: flags[:-1].zero_())
    rp.check_ring_error(flags[-1:])  # sticky over every timed launch
    want = rp.ring_all_gather_plain(shards)
    same_bytes(f"{name} {label} (timed)", out, want)
    rec.record(f"{name} {label}", name, RING_SRC, RING_REPLACES[name],
               as_u8(out[0]), as_u8(want[0]), ms,
               time_ms(lambda: rp.ring_all_gather_plain(shards), flush,
                       iters=5),
               time_ms(lambda: stacked.reshape(1, -1).expand(
                   n, -1).contiguous(), flush),
               0, n * C + n * n * C)
    rec.rows[f"{name} {label}"].update(bytes_a_rank=C)
    flags.zero_()
    try:  # more CTAs than stay resident: refused at launch, never hangs
        rp._ring_all_gather_into(shards, out, comm, flags,
                                 ctas=rp.resident_ctas(shards[0].device) // n
                                 + 1)
    except KernelLaunchError:
        pass
    else:
        raise AssertionError(f"{name}: a launch too large to stay resident "
                             "was not refused")
    try:  # waits with no budget: the error word set, the wrapper raises
        rp.check_ring_error(rp._ring_all_gather_into(shards, out, comm,
                                                     flags, budget=0))
    except KernelLaunchError:
        pass
    else:
        raise AssertionError(f"{name}: waits with no spin budget did not "
                             "fail")
    same_bytes(f"{name} {label} after the failed ring",
               rp.ring_all_gather_p2p_shards(shards), want)


def check_ring(rec, flush, dev):
    """Phase 3 of path (t), launches uncounted. Returns the case count."""
    from leetcuda_tpu_torch.models.llama import qwen3_30b_a3b_config

    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    cases = 0
    with uncounted():
        for n in PAR_RANKS:
            for dname, dtype in PAR_DTYPES.items():
                for shape in PAR_SMALL:
                    ring_case(rank_shards(gen, n, shape, dtype, dev),
                              f"{n} ranks {dname} {shape}")
                    cases += 1
        cfg = qwen3_30b_a3b_config()
        kshape = (1, cfg.n_kv_heads, PAR_N // PAR_SP, cfg.head_dim)
        ring_rows(rec, flush, f"K shard {kshape} bf16 x {PAR_SP}",
                  rank_shards(gen, PAR_SP, kshape, torch.bfloat16, dev))
        ring_rows(rec, flush, f"{PAR_BIG >> 20} MiB x {PAR_SP}",
                  rank_shards(gen, PAR_SP, (PAR_BIG // 2,), torch.bfloat16,
                              dev))
    return cases + 2


def check_parallel_attn(rec, flush, dev):
    """Phase 3 of path (t), launches uncounted: the attention kernels at the
    shapes the main path gives them, against their plain versions. A ring
    rank's step (flash_attention with its lse: q (1, 32, 4096, 128) over a
    KV chunk (1, 4, 4096, 128), the diagonal causal and an earlier chunk in
    full; out and lse, timed, with ``lse_case``'s control), a Ulysses rank's
    call (flash_attention, (1, 8, 32768, 128) over (1, 1, 32768, 128), its
    first PAR_HELD_ROWS query rows), and every rank's decode_attention with
    its lse over its cache slice on the sp = 8 and dp = 2 x sp = 4 meshes
    (the local lengths clipped: whole rows empty; NaN past every length;
    the PAR_TIMED_RANKS calls timed by ``lse_case``). Returns the errors of
    the untimed checks."""
    from leetcuda_tpu_torch.attention import decode as dec
    from leetcuda_tpu_torch.attention import flash as fl
    from leetcuda_tpu_torch.models.llama import qwen3_30b_a3b_config
    from leetcuda_tpu_torch.parallel.mesh import split

    cfg = qwen3_30b_a3b_config()
    H, Hkv, D, N = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, PAR_N
    n_loc, errs = N // PAR_SP, {}
    with uncounted():
        q = rec.randn(1, H, n_loc, D)
        k, v = rec.randn(1, Hkv, n_loc, D), rec.randn(1, Hkv, n_loc, D)
        for causal in (True, False):
            pairs = n_loc * (n_loc + 1) // 2 if causal else n_loc * n_loc
            lse_case(rec, flush, f"(t) flash_attention_lse ring step "
                     f"{'diagonal, causal' if causal else 'earlier chunk'} "
                     f"q {tuple(q.shape)} kv {tuple(k.shape)}",
                     "flash_attention_lse", FLASH_SRC,
                     "leetcuda_tpu/attention/flash.py:259",
                     fl.flash_attention, fl.flash_attention_plain,
                     (q, k, v), {"causal": causal}, 4.0 * H * pairs * D,
                     2.0 * (2 * q.numel() + k.numel() + v.numel()),
                     4.0 * H * n_loc,
                     lambda c=causal: sdpa(q, k, v, is_causal=c))
        del q, k, v
        hu, hk, R = H // PAR_ULYSSES_SP, Hkv // PAR_ULYSSES_SP, PAR_HELD_ROWS
        q, k, v = rec.randn(1, hu, N, D), rec.randn(1, hk, N, D), \
            rec.randn(1, hk, N, D)
        for causal in (True, False):
            nk = R if causal else N  # the keys the held rows attend
            errs[f"ulysses rank call causal={causal}"] = hold(
                fl.flash_attention(q, k, v, causal=causal)[:, :, :R],
                fl.flash_attention_plain(q[:, :, :R], k[:, :, :nk],
                                         v[:, :, :nk], causal=causal))
        del q, k, v

        gen = torch.Generator(device=dev).manual_seed(PAR_SEED + 2)
        B = len(PAR_DECODE_LENS)
        qd, kc, vc = (torch.randn(shape, generator=gen, device=dev,
                                  dtype=torch.bfloat16)
                      for shape in ((B, H, D), (B, Hkv, N, D),
                                    (B, Hkv, N, D)))
        lens = torch.from_numpy(PAR_DECODE_LENS).to(dev)
        past = torch.arange(N, device=dev)[None, :] >= lens[:, None]
        kc.masked_fill_(past[:, None, :, None], float("nan"))
        vc.masked_fill_(past[:, None, :, None], float("nan"))
        for label, (n_dp, n_sp) in (("sp=8", (1, PAR_SP)),
                                    ("dp=2 x sp=4", (2, 4))):
            s_loc, b_loc = N // n_sp, B // n_dp
            for d in range(n_dp):
                rows = slice(d * b_loc, (d + 1) * b_loc)
                ks, vs = (split(t[rows], [dev] * n_sp, 2) for t in (kc, vc))
                for i in range(n_sp):
                    li = torch.clamp(lens[rows] - i * s_loc, 0, s_loc)
                    args = (qd[rows], ks[i], vs[i], li)
                    got, got_lse = dec.decode_attention(*args, with_lse=True)
                    want, want_lse = dec.decode_attention_plain(
                        *args, with_lse=True)
                    if not torch.isfinite(got).all():
                        raise AssertionError(f"decode rank {d}, {i} "
                                             f"({label}): non-finite output")
                    errs[f"decode {label} rank ({d}, {i})"] = max(
                        hold(got, want), hold(got_lse, want_lse))
                    if (d, i) != PAR_TIMED_RANKS[label]:
                        continue
                    n_att = int(li.sum())
                    mask = (torch.arange(s_loc, device=dev)[None, :]
                            < li[:, None])[:, None, None, :]
                    kd, vd = torch.nan_to_num(ks[i]), torch.nan_to_num(vs[i])
                    lse_case(rec, flush, f"(t) decode_attention_lse {label} "
                             f"rank ({d}, {i}) B={b_loc} S={s_loc} lengths "
                             f"{li.tolist()}", "decode_attention_lse",
                             DECODE_SRC,
                             "leetcuda_tpu/attention/decode.py:223",
                             dec.decode_attention, dec.decode_attention_plain,
                             args, {}, 4.0 * H * D * n_att,
                             4.0 * Hkv * n_att * D + 4.0 * b_loc * H * D
                             + 4 * b_loc, 4.0 * b_loc * H,
                             lambda q_=qd[rows], kd=kd, vd=vd, m=mask: sdpa(
                                 q_[:, :, None], kd, vd, attn_mask=m))
    return errs


def row_rel_l2(got, want, dims):
    """The largest relative L2 error of a row, ||got - want|| / ||want||
    over ``dims``, in f32."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=dims) / w.norm(dim=dims)).max())


@contextlib.contextmanager
def patched(module, name, value):
    """``module.name`` is ``value`` inside (a control's broken step)."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def attn_pair(flush, name, run, single, dims, controls=()):
    """A distributed attention ``run`` against the single-device ``single``:
    at KERNEL_TOL, and every row's relative L2 over ``dims`` under
    PAR_REL_L2; each control (a label and a context that breaks one step of
    the distributed path: uncounted) must miss PAR_REL_L2. Max error, the
    worst row's relative L2, the controls' and both times."""
    got, want = run(), single()
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = hold(got, want)
    rel = row_rel_l2(got, want, dims)
    if rel > PAR_REL_L2:
        raise AssertionError(f"{name}: a row's relative L2 {rel:.3g} over "
                             f"{PAR_REL_L2}")
    ctl = {}
    with uncounted():
        for label, broken in controls:
            with broken():
                ctl[label] = row_rel_l2(run(), want, dims)
            if ctl[label] <= PAR_REL_L2:  # NaN misses too
                raise AssertionError(f"{name}: the control '{label}' passes "
                                     f"(relative L2 {ctl[label]:.3g})")
        ms = time_ms(run, flush, iters=3, warmup=1)
        single_ms = time_ms(single, flush, iters=3, warmup=1)
    return {"max_abs_err": err, "rel_l2": rel, "controls_rel_l2": ctl,
            "ms": ms, "single_device_ms": single_ms}


def parallel_main(dev, flush, gen):
    """Path (t)'s main path (counted by ``drive``)."""
    from leetcuda_tpu_torch.attention.decode import decode_attention
    from leetcuda_tpu_torch.attention.flash import flash_attention
    from leetcuda_tpu_torch.models.llama import (ModelConfig, forward,
                                                 init_params,
                                                 pipeline_forward,
                                                 qwen3_30b_a3b_config)
    from leetcuda_tpu_torch.parallel import collectives, cp_decode, ring
    from leetcuda_tpu_torch.parallel.mesh import (Mesh, MeshConfig,
                                                  all_to_all, make_mesh,
                                                  ppermute)
    from leetcuda_tpu_torch.parallel.ring_p2p import (ppermute_p2p,
                                                      ring_all_gather_p2p)

    res = {}
    cfg = qwen3_30b_a3b_config()
    H, Hkv, D, N = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, PAR_N
    sp = make_mesh(MeshConfig(sp=PAR_SP), devices=[dev] * PAR_SP)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    q, k, v = randn(1, H, N, D), randn(1, Hkv, N, D), randn(1, Hkv, N, D)

    # the sequence-sharded K and V around the ring (sequence-major rows)
    t0 = time.perf_counter()
    for name, x in (("k", k), ("v", v)):
        rows = x[0].transpose(0, 1).contiguous()  # (N, Hkv, D)
        shifted = ppermute_p2p(rows, sp, axis="sp")
        if not torch.equal(as_u8(shifted), as_u8(torch.roll(
                rows, N // PAR_SP, 0))):
            raise AssertionError(f"ppermute_p2p of {name}: not the shards "
                                 "rotated one rank")
        if not torch.equal(as_u8(ring_all_gather_p2p(rows, sp, axis="sp")),
                           as_u8(rows)):
            raise AssertionError(f"ring_all_gather_p2p of {name}: not the "
                                 "whole array")
    sync(torch.device(dev))
    res["kv_ring_s"] = time.perf_counter() - t0

    # the nine demos over 8 ranks, against their known answers
    c = np.arange(8 * 8, dtype=np.float32).reshape(8, 8)  # rank j: c[j]
    expect = {"broadcast": np.tile(c[0], 8), "all_reduce": np.tile(
        c.sum(0), 8), "reduce_max": np.tile(c.max(0), 8),
        "all_gather": c.ravel(), "gather": c.ravel(), "scatter": c.ravel(),
        "reduce_scatter": 8 * c.ravel(), "all_to_all": c.T.ravel(),
        "p2p": np.roll(c, 1, 0).ravel()}
    got = collectives.run_all([dev] * 8, verbose=False)
    for name, want in expect.items():
        np.testing.assert_array_equal(got[name].cpu().numpy(), want,
                                      err_msg=name)
    res["demos"] = sorted(got)

    def last_hop_dropped():  # the ring's last rotation of K and V skipped
        hops = []

        def hop(xs, *a):
            hops.append(1)
            return list(xs) if len(hops) > 2 * (PAR_SP - 2) else ppermute(
                xs, *a)
        return patched(ring, "ppermute", hop)

    def heads_misrouted():  # Ulysses' return trip from the wrong ranks
        calls = []

        def a2a(xs, *a):
            calls.append(1)
            return all_to_all(xs[::-1] if len(calls) == 4 else xs, *a)
        return patched(ring, "all_to_all", a2a)

    ring_controls = (
        ("equal weights", lambda: patched(
            ring, "_merge", lambda o1, l1, o2, l2, m=ring._merge: m(
                o1, l1, o2, l1))),
        ("last hop dropped", last_hop_dropped))
    for causal in (False, True):
        res[f"ring causal={causal}"] = attn_pair(
            flush, "ring_attention",
            lambda: ring.ring_attention(q, k, v, sp, causal=causal),
            lambda: flash_attention(q, k, v, causal=causal), (1, 3),
            ring_controls)
        uly = make_mesh(MeshConfig(sp=PAR_ULYSSES_SP),
                        devices=[dev] * PAR_ULYSSES_SP)
        res[f"ulysses causal={causal}"] = attn_pair(
            flush, "ulysses_attention",
            lambda: ring.ulysses_attention(q, k, v, uly, causal=causal),
            lambda: flash_attention(q, k, v, causal=causal), (1, 3),
            (("heads misrouted", heads_misrouted),))
    del q, k, v

    B = len(PAR_DECODE_LENS)
    qd, kc, vc = randn(B, H, D), randn(B, Hkv, N, D), randn(B, Hkv, N, D)
    lens = torch.from_numpy(PAR_DECODE_LENS).to(dev)
    past = (torch.arange(N, device=dev)[None, :] >= lens[:, None])
    kc.masked_fill_(past[:, None, :, None], float("nan"))
    vc.masked_fill_(past[:, None, :, None], float("nan"))
    for label, mesh in (("sp=8", sp), ("dp=2 x sp=4", make_mesh(
            MeshConfig(dp=2, sp=4), devices=[dev] * 8))):
        s_loc = N // mesh.shape["sp"]
        empty = int(sum((PAR_DECODE_LENS <= i * s_loc).sum()
                        for i in range(mesh.shape["sp"])))
        cp = cp_decode.make_decode_attention_cp(mesh)
        res[f"cp_decode {label}"] = {
            **attn_pair(flush, f"cp decode {label}",
                        lambda: cp(qd, kc, vc, lens),
                        lambda: decode_attention(qd, kc, vc, lens), (1, 2),
                        (("equal weights", lambda: patched(
                            cp_decode, "pmax", list)),)),
            "empty_rank_rows": empty}
    del qd, kc, vc

    mcfg = ModelConfig()
    params = init_params(torch.Generator(device=dev).manual_seed(PAR_SEED),
                         mcfg, device=dev)
    toks = torch.randint(0, mcfg.vocab_size, (PAR_PP_B, PAR_PP_S),
                         generator=gen, device=dev, dtype=torch.int32)
    pp = Mesh([dev] * PAR_PP, ("pp",))
    with torch.no_grad():
        t1 = time.perf_counter()
        got = pipeline_forward(params, toks, mcfg, pp,
                               n_microbatches=PAR_PP_M)
        sync(torch.device(dev))
        t2 = time.perf_counter()
        want = forward(params, toks, mcfg)
        sync(torch.device(dev))
        t3 = time.perf_counter()
    if not torch.isfinite(got).all():
        raise AssertionError("pipeline_forward: non-finite logits")
    res["pipeline"] = {"max_abs_err": hold(got, want),
                       "pipeline_s": t2 - t1, "forward_s": t3 - t2,
                       "n_layers": mcfg.n_layers}
    return res


def parallel_path(dev="cuda"):
    """Path (t): ``check_ring`` (rows for the kernels line), then the main
    path with the launch counts zeroed just before and read just after.
    Returns (rows, the path's report)."""
    t0 = time.perf_counter()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    rec = Recorder(dev)
    res = {"ring_cases": check_ring(rec, flush, dev),
           "attn_checks": check_parallel_attn(rec, flush, dev)}
    torch.cuda.empty_cache()
    res["phase3_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED + 1)
    out, counts, peak = drive("t", lambda: parallel_main(dev, flush, gen))
    res.update(out, launches=counts, peak_extra_bytes=peak,
               seconds=time.perf_counter() - t0)
    return rec.rows, res


def print_parallel(rows, res):
    for r in rows.values():
        lse = ("" if "lse_controls" not in r else
               f"; out max_abs_err {r['out_max_abs_err']:.3g}, "
               f"{r['ms_without_lse']:.4f} ms without the lse; lse "
               f"controls {r['lse_controls']}")
        print(f"kernel {r['check']}: max_abs_err {r['max_abs_err']:.3g} "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms library "
              f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){lse}", flush=True)
    print(f"path (t) the ring kernels bit for bit over {res['ring_cases']} "
          f"cases (ranks {PAR_RANKS}, {list(PAR_DTYPES)}, shards "
          f"{PAR_SMALL} and two timed payloads) in {res['phase3_s']:.1f} s; "
          f"K and V around the ring in {res['kv_ring_s']:.3f} s; the nine "
          f"demos {res['demos']}", flush=True)
    print(f"path (t) untimed kernel checks against the plain versions "
          f"(max_abs_err): {res['attn_checks']}", flush=True)
    for key in [k for k in res if k.startswith(("ring ", "ulysses ",
                                                 "cp_decode "))]:
        r = res[key]
        print(f"path (t) {key}: max_abs_err {r['max_abs_err']:.3g} (tol "
              f"{KERNEL_TOL['atol']}), worst row's relative L2 "
              f"{r['rel_l2']:.3g} (tol {PAR_REL_L2}; controls, which must "
              f"miss it: {r['controls_rel_l2']}), {r['ms']:.3f} ms against "
              f"one device's {r['single_device_ms']:.3f} ms"
              + (f"; {r['empty_rank_rows']} (row, rank) pairs empty"
                 if "empty_rank_rows" in r else ""), flush=True)
    p = res["pipeline"]
    print(f"path (t) pipeline_forward pp={PAR_PP} M={PAR_PP_M} B={PAR_PP_B} "
          f"S={PAR_PP_S}, {p['n_layers']} layers: logits max_abs_err "
          f"{p['max_abs_err']:.3g} against forward (tol "
          f"{KERNEL_TOL['atol']}); {p['pipeline_s']:.3f} s against "
          f"{p['forward_s']:.3f} s; path {res['seconds']:.1f} s", flush=True)
    print(f"  launches: { {k: v for k, v in res['launches'].items() if v} }")


def drive(path, fn):
    """Run one main path with the launch counts zeroed just before and read
    just after; fail if a kernel of the path was not launched. Returns the
    path's result, its launch counts and the device memory it allocated at
    its peak on top of what was resident before it (caches, activations)."""
    from leetcuda_tpu_torch.core.runtime import (launch_counts,
                                                 reset_launch_counts)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = fn()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    missing = [n for n in PATH_KERNELS[path] if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"path {path}: kernels not launched: {missing}")
    forbidden = (PATH_FORBIDDEN.get(path, ())
                 + (TRAIN_KERNELS if path not in ("i", "s") else ())
                 + (GEMM_KERNELS if not path.startswith("j") else ())
                 + (ROW_KERNELS if not path.startswith("k") else ())
                 + (CORPUS_KERNELS if not path.startswith("l") else ())
                 + (FLAT_KERNELS if not path.startswith("m") else ())
                 + (MOE_KERNELS if path != "n" else ()))
    stray = [n for n in forbidden
             if counts.get(n, 0) and n not in PATH_KERNELS[path]]
    if stray:
        raise AssertionError(f"path {path}: launched {stray}")
    return out, counts, peak


def param_bytes(params):
    def walk(x):
        if isinstance(x, dict):
            return sum(walk(v) for v in x.values())
        if isinstance(x, (list, tuple)):
            return sum(walk(v) for v in x)
        return x.nbytes
    return walk(params)


def check_served(params, cfg, prompts, served, gprompts, gtoks, graphs):
    """Phase 5 (bf16 path): teacher-forced gaps of every served stream. The
    requests of the ragged admission (all but the last) replay their prompt
    through a B=1 ``forward``, as the other paths' replays do (a kernel the
    ragged admission never ran); the lone request, which the Engine
    prefilled through ``forward``, and the ``generate`` streams replay token
    by token through ``decode_step``; the decode steps through ``graphs``
    (a StepGraphs of ``params`` without KV quantization)."""
    gaps = {}
    for i, (prompt, toks) in enumerate(zip(prompts, served)):
        if i == len(prompts) - 1:
            gaps[f"engine/{i}"] = teacher_forced_gap(params, cfg, prompt, toks,
                                                     graphs)
        else:
            gaps[f"engine/{i}"] = replay_gap(params, cfg, prompt, toks, None,
                                             graphs)
    g_np = gtoks.cpu().numpy()
    for b in range(g_np.shape[0]):
        gaps[f"generate/{b}"] = teacher_forced_gap(
            params, cfg, gprompts[b].tolist(), g_np[b].tolist(), graphs)
    return gaps


def agreement(params, qparams, cfg, prompt):
    """Top-1 agreement and max |logit difference| of a quantized forward
    against the bf16 forward over one prompt."""
    from leetcuda_tpu_torch.models.llama import forward

    a = forward(params, prompt, cfg)
    b = forward(qparams, prompt, cfg)
    return {"top1": float((a.argmax(-1) == b.argmax(-1)).float().mean()),
            "max_abs_dlogit": float((a - b).abs().max())}


def profile_decode(params, cfg, batch, context, steps=8, kv_quant=None,
                   paged=False, classes=None, split=None):
    """Phase 6: where a B=``batch`` decode step's time goes. The step's wall
    time (host clock, synchronised) without the profiler, then
    torch.profiler's device time by kernel over the same steps: the device
    busy share is device time over wall time. ``paged``: over page pools
    (pages of PAGE) with every row's pages allocated. The table is uploaded
    once, before the steps: the upload from pageable memory waits for the
    stream, which costs the engine nothing (it reads the sampled tokens
    back at the end of every step) but would serialise this loop, whose
    host otherwise runs ahead of the device. ``classes`` and ``split``: as
    ``profile_run``'s."""
    from leetcuda_tpu_torch.attention.paged import PageManager
    from leetcuda_tpu_torch.models.llama import (decode_step, init_kv_caches,
                                                 init_paged_kv_caches)

    dev = params["embed"].device
    capacity = context + 2 * steps
    capacity += -capacity % 1024
    pm = None
    if paged:
        pm = PageManager(batch * capacity // PAGE + 1, PAGE, capacity // PAGE,
                         batch)
        for slot in range(batch):
            if not pm.ensure(slot, capacity - 1):
                raise AssertionError("profile pool too small")
        caches = init_paged_kv_caches(cfg, batch * capacity // PAGE + 1, PAGE,
                                      quant=kv_quant, device=dev)
    else:
        caches = init_kv_caches(cfg, batch, capacity, quant=kv_quant,
                                device=dev)
    tok = torch.zeros(batch, dtype=torch.int32, device=dev)
    table = pm.device_table(dev) if paged else None

    def run():
        lengths = torch.full((batch,), context, dtype=torch.int32,
                             device=dev)
        for _ in range(steps):
            decode_step(params, tok, caches, lengths, cfg, page_table=table)
            lengths += 1
        sync(dev)

    return {"batch": batch, "context": context, "kv_quant": kv_quant,
            "paged": paged, **profile_run(run, steps, classes, split)}


# Device time of a training step by kind of kernel (substrings of the
# kernel names): the hand-written attention kernels and cuBLAS's products.
TRAIN_CLASSES = {"attention": ("flash_fwd", "flash_bwd"),
                 "matmul": ("gemm", "sm90", "nvjet", "cutlass", "cublas")}


def split_by_layer(prof, substr, n_layers, steps):
    """Device ms per step of the kernels whose name holds ``substr`` (one
    per layer, launched in layer order), summed over the even and the odd
    layers apart: {"even", "odd", "launches"}, or None when the trace holds
    no such kernel with a time range."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.elapsed_us())
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA and substr in e.name
                   and getattr(e, "time_range", None) is not None)
    if not spans or len(spans) % n_layers:
        return None
    out = {"even": 0.0, "odd": 0.0, "launches": len(spans)}
    for i, (_, us) in enumerate(spans):
        out["odd" if i % n_layers % 2 else "even"] += us / 1e3 / steps
    return out


def profile_run(run, steps, classes=None, split=None):
    """``run()`` performs ``steps`` steps and synchronises: its wall time per
    step without the profiler (after one warm-up run), then torch.profiler's
    device time by kernel over one more run; with ``classes`` ({label:
    name substrings}) also the device ms per step of each class and of the
    rest; with ``split`` (name substring, layers) also ``split_by_layer``."""
    from torch.profiler import ProfilerActivity, profile

    run()
    t0 = time.perf_counter()
    run()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0 and e.device_type.name == "CUDA":
            by_kernel[e.key] = (us / 1e3 / steps, e.count // steps)
    device_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    by_class = {}
    for name, (ms, _) in by_kernel.items():
        label = next((c for c, subs in (classes or {}).items()
                      if any(x in name.lower() for x in subs)), "other")
        by_class[label] = by_class.get(label, 0.0) + ms
    split_ms = (split_by_layer(prof, *split, steps) if split is not None
                else None)
    return {"step_ms": step_ms, "device_ms_per_step": device_ms,
            "device_ms_by_class": by_class, "split_ms": split_ms,
            "launches_per_step": sum(n for _, n in by_kernel.values()),
            "device_busy_share": device_ms / step_ms if device_ms else None,
            "top_kernels": [{"kernel": k[:90], "ms_per_step": ms,
                             "launches_per_step": n}
                            for k, (ms, n) in top]}


def profile_verify_tick(target, draft, cfg, batch, context, k, ticks=4):
    """Phase 6: one speculative tick of path (f) at B=``batch``: k draft
    proposals and the draft's catch-up step over a contiguous bf16 cache,
    then the (k + 1)-token verify over paged bf16 pools and the greedy accept
    rule; nothing is read back, and every tick starts at ``context``."""
    from leetcuda_tpu_torch.attention.paged import PageManager
    from leetcuda_tpu_torch.engine.speculative import (_draft_propose,
                                                       decode_chunk,
                                                       greedy_verdict)
    from leetcuda_tpu_torch.models.llama import (init_kv_caches,
                                                 init_paged_kv_caches)

    dev = target["embed"].device
    capacity = context + 1024 - context % 1024
    n_pages = batch * capacity // PAGE + 1
    pm = PageManager(n_pages, PAGE, capacity // PAGE, batch)
    for slot in range(batch):
        if not pm.ensure(slot, capacity - 1):
            raise AssertionError("profile pool too small")
    caches = init_paged_kv_caches(cfg, n_pages, PAGE, device=dev)
    caches_d = init_kv_caches(cfg, batch, capacity, device=dev)
    table = pm.device_table(dev)
    tok = torch.zeros(batch, dtype=torch.int32, device=dev)
    lengths = torch.full((batch,), context, dtype=torch.int32, device=dev)

    def run():
        for _ in range(ticks):
            chunk, _ = _draft_propose(draft, cfg, caches_d, tok, lengths, k,
                                      capacity)
            logits, _ = decode_chunk(target, chunk, caches, lengths, cfg,
                                     page_table=table)
            greedy_verdict(chunk, logits)
        sync(dev)

    return {"batch": batch, "context": context, "kv_quant": None,
            "paged": True, "spec_k": k, **profile_run(run, ticks)}


def print_profile(label, prof, what="decode step"):
    busy = prof["device_busy_share"]
    print(f"{what} {label} B={prof['batch']} at context "
          f"{prof['context']}: {prof['step_ms']:.3f} ms wall, "
          f"{prof['device_ms_per_step']:.3f} ms on the device in "
          f"{prof['launches_per_step']} launches (busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'})")
    for t in prof["top_kernels"]:
        print(f"  {t['ms_per_step']:.4f} ms x{t['launches_per_step']} "
              f"{t['kernel']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="write every measured number here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    from leetcuda_tpu_torch.build import build_all
    from leetcuda_tpu_torch.engine import generate
    from leetcuda_tpu_torch.models.llama import (ModelConfig, fuse_params,
                                                 init_params, quantize_params)

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # 2. build
    t0 = time.perf_counter()
    reports = build_all()
    report["build_s"] = time.perf_counter() - t0
    phase_s = report["phase_s"] = {}
    marks = [t0]

    def phase_done(name, **results):
        """Seconds since the previous phase ended; with ``--json`` the report
        so far (and ``results``) is written after every phase, so that a
        run cut short keeps what it measured."""
        marks.append(time.perf_counter())
        phase_s[name] = marks[-1] - marks[-2]
        report.setdefault("partial", {}).update(results)
        if args.json:
            Path(args.json).parent.mkdir(parents=True, exist_ok=True)
            Path(args.json).write_text(json.dumps(report, indent=1,
                                                  default=str))

    print(f"build: {sorted(reports)} in {report['build_s']:.1f} s")
    report["build_resources"] = {
        name: [line.strip() for line in log.splitlines()
               if "registers" in line or "spill" in line]
        for name, log in reports.items()}
    for name, lines in report["build_resources"].items():
        for line in lines:
            print(f"  {name}: {line}")
    for key, name, needle in (("resident_ptxas", "matmul_resident",
                               "mm_resident"),
                              ("flash_bwd_ptxas", "flash_bwd", "flash_bwd"),
                              ("flash_fwd_ptxas", "flash_fwd", "flash_fwd"),
                              ("w4_ptxas", "w4_matmul", "w4_mm"),
                              ("w8_ptxas", "wq_matmul", ""),
                              ("hgemm_ptxas", "matmul", "gemm_sm90"),
                              ("gmm_ptxas", "gmm", "gmm_sm90"),
                              ("ln_bwd_ptxas", "row_ops", "ln_bwd_rows")):
        report[key] = ptxas_entries(reports.get(name, ""), needle)
        for e in report[key]:
            print(f"  {name} {e['kernel']}: {e.get('registers')} "
                  f"registers, {e.get('spill_stores')} / "
                  f"{e.get('spill_loads')} bytes of spill stores / loads")

    phase_done("build")

    # path (n) first, on an empty card: Qwen3-30B-A3B's weights take 60.5 GB
    nrows, nres = moe_path()
    torch.cuda.empty_cache()
    print_moe(nrows, nres)
    phase_done("moe", n=nres)

    # path (o) next, on the card emptied again: Gemma-2-27B's weights take
    # 54.4 GB, and its phase-3 plain versions at N=8192 ~35 GB before them
    orows, ores = gemma_path()
    torch.cuda.empty_cache()
    print_gemma(orows, ores)
    phase_done("gemma", o=ores, o_checks=orows)

    # path (p) next, on the card emptied again: GPT-OSS-20B's weights take
    # 41.8 GB, and each layer's dense combine 3.2 GB of f32 experts
    prows, pres = gptoss_path()
    torch.cuda.empty_cache()
    print_gptoss(prows, pres)
    phase_done("gptoss", p=pres, p_checks=prows)

    # path (q) next, on the card emptied again: DeepSeek-V2-Lite's weights
    # take 31.4 GB, and each MoE layer's dense combine 2.2 GB of f32 experts
    qrows, qres = mla_path()
    torch.cuda.empty_cache()
    print_mla(qrows, qres)
    phase_done("mla", q=qres, q_checks=qrows)

    # path (r) next, on the card emptied again: Gemma-2-9B at head dim 256,
    # 18.5 GB of weights and 11 GB more of their fused copies
    rrows, rres = gemma_path(tag="r")
    torch.cuda.empty_cache()
    print_gemma(rrows, rres)
    phase_done("gemma9b", r=rres, r_checks=rrows)

    # path (s) next, on the card emptied again: Gemma-2-2B trained at B=1,
    # S=8192 (params, grads and AdamW moments in bf16, 21 GB; the f32
    # logits of 8192 rows over 256000 tokens, 8.4 GB each)
    srows, sres = gemma_train_path()
    torch.cuda.empty_cache()
    print_gemma_train(srows, sres)
    phase_done("gemma2b_train", s=sres, s_checks=srows)

    # path (t) next: the parallel layer on 8 ranks of the card
    trows, tres = parallel_path()
    torch.cuda.empty_cache()
    print_parallel(trows, tres)
    phase_done("parallel", t=tres, t_checks=trows)

    # the full-width model, its quantized params and the paths' requests
    cfg = ModelConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params(gen, cfg, device="cuda")
    fparams = fuse_params(params)  # dense fused: path (d)
    qparams = {
        name: quantize_params(fparams if fuse else params, w)
        for name, (w, fuse, _) in QUANT_PATHS.items()}
    rng = np.random.default_rng(1)
    plens = np.linspace(16, 1500, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in plens]
    lone = rng.integers(0, cfg.vocab_size, 300).tolist()
    gprompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (8, 128)).astype(np.int32)).cuda()

    # 3. kernels against their plain versions. The rows each path gives a
    # projection: 8 (a decode step over 8 slots or a B=8 batch), the padded
    # ragged admission (8 x 1536) and the lone prompt (384) of the Engine,
    # generate's B=8 x 128 prefill; and 16-128 rows on paths (a) and (c),
    # where the two routes of each matmul cross over; on (a) and (c) also
    # 1, 9 and 72 rows (the kernels' row tiles of 8 and 64 ragged).
    bucket = 128

    def pad(n):
        return -(-n // bucket) * bucket

    sweep = (16, 32, 64, 128)
    path_rows = {"a": (1, 8, 9, 72, len(prompts) * pad(int(max(plens))),
                       pad(len(lone)), *sweep),
                 "b": (8, gprompts.numel()),
                 "c": (1, 8, 9, 72, gprompts.numel(), *sweep)}
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device="cuda")
    checks = check_kernels(flush, matmul_cases(qparams, path_rows),
                           fparams["layers"][0], cfg)
    for r in checks.values():
        tiles = ("" if "ms_decode_tile" not in r else
                 f" [decode route {r['ms_decode_tile']:.4f} ms, prefill "
                 f"route {r['ms_prefill_tile']:.4f} ms]")
        lib = (f"library {r['library_ms']:.4f} ms"
               if r["library_ms"] is not None else
               f"library none [eager unfused {r['eager_unfused_ms']:.4f} ms, "
               f"torch.matmul alone {r['matmul_ms']:.4f} ms]")
        if "rel_l2" in r:  # the backward: SDPA's backend and the whole
            errs = ", ".join(f"{n} {e:.3g}" for n, e in r["rel_l2"].items())
            lib += (f" ({r['library_kernel']}); relative L2 {errs}; whole "
                    f"backward {r['backward_ms']:.4f} ms, bound of its 5 "
                    f"products {r['backward_bound_ms']:.4f} ms;")
            if r.get("cap_controls_rel_l2"):
                lib += (f" the cap's controls (relative L2, must fail "
                        f"{BWD_REL_L2}): {r['cap_controls_rel_l2']};")
        print(f"kernel {r['check']}: max_abs_err {r['max_abs_err']:.3g} "
              f"kernel {r['ms']:.4f} ms{tiles} plain {r['plain_ms']:.4f} ms "
              f"{lib} bound {r['bound_ms']:.4f} ms ({r['bound_by']})",
              flush=True)
    checks.update(nrows)
    checks.update(orows)
    checks.update(prows)
    checks.update(qrows)
    checks.update(rrows)
    checks.update(srows)
    checks.update(trows)
    report["kernel_checks"] = checks
    phase_done("kernel_checks")
    del flush

    # path (j): the GEMM library on layer 0 of the dense fused params
    jrows, jres = gemm_library(fparams["layers"][0], fparams["embed"], card)
    print_gemm(jrows, jres)
    checks.update(jrows)
    phase_done("gemm_library")

    # path (k): the row ops and split-KV attention (layer 0's attn_norm)
    krows, kres = row_ops_path(params["layers"][0])
    print_row_ops(krows, kres)
    checks.update(krows)
    phase_done("row_ops")

    # path (l): transpose, embedding (the model's table), RoPE, the chain
    lrows, lres = corpus_path(params["embed"])
    print_corpus(lrows, lres)
    checks.update(lrows)
    phase_done("corpus")

    # path (m): the add, activations, reductions, dot product, histogram
    mrows, mres = flat_path()
    print_flat(mrows, mres)
    checks.update(mrows)
    phase_done("flat")

    # 4. the main paths at full width
    # warm-up: cuBLAS, library loads
    generate(params, cfg, gprompts[:1, :16], 2)
    for name, (_, _, kvq) in QUANT_PATHS.items():
        generate(qparams[name], cfg, gprompts[:1, :16], 2, kv_quant=kvq)
    torch.cuda.synchronize()

    def bf16_path():
        eng, served = serve_engine(params, cfg, prompts, lone, max_new=32,
                                   max_seq=2048, bucket=bucket)
        gen_, gtoks = serve_generate(params, cfg, gprompts, 64)
        return {**eng, **gen_}, served, gtoks

    (main_path, served, gtoks), counts, peak = drive("bf16", bf16_path)
    main_path.update(launches=counts, peak_extra_bytes=peak)
    main_path["weight_bytes"] = param_bytes(params)
    main_path["tok_s_ceiling"] = 8 / (main_path["weight_bytes"]
                                      / HBM_BYTES_PER_S)
    for what in ("engine_tok_s", "generate_tok_s"):
        if main_path[what] > main_path["tok_s_ceiling"]:
            raise AssertionError(f"{what} {main_path[what]:.0f} exceeds the "
                                 f"weight-bandwidth ceiling "
                                 f"{main_path['tok_s_ceiling']:.0f}")
    print(f"path bf16: engine 8 requests (prompts {plens.tolist()}) x 32 "
          f"tokens in {main_path['engine_batch_s']:.3f} s = "
          f"{main_path['engine_tok_s']:.1f} tok/s (admission "
          f"{main_path['engine_admit_s']:.3f} s); lone request "
          f"{main_path['lone_request_s']:.3f} s; generate B=8 S=128 x 64: "
          f"{main_path['generate_s']:.3f} s = "
          f"{main_path['generate_tok_s']:.1f} tok/s; ceiling "
          f"{main_path['tok_s_ceiling']:.0f} tok/s; params "
          f"{main_path['weight_bytes'] / 2**30:.2f} GiB, caches and "
          f"activations at peak {peak / 2**30:.2f} GiB", flush=True)
    print(f"  launches: {counts}")
    report["paths"] = {"bf16": main_path, "j": jres, "k": kres, "l": lres,
                       "m": mres, "n": nres, "o": ores, "p": pres,
                       "p2": pres["speculative"], "q": qres, "r": rres,
                       "s": sres, "t": tres}

    qserved = {}
    for name, (wfmt, fuse, kvq) in QUANT_PATHS.items():
        qp = qparams[name]
        if name == "a":
            (res, toks), counts, peak = drive(name, lambda: serve_engine(
                qp, cfg, prompts, lone, max_new=32, max_seq=2048,
                bucket=bucket, kv_quant=kvq))
            tok_s = res["engine_tok_s"]
            qserved[name] = list(zip(prompts + [lone], toks))
        else:
            (res, toks), counts, peak = drive(name, lambda: serve_generate(
                qp, cfg, gprompts, 32, kv_quant=kvq))
            tok_s = res["generate_tok_s"]
            qserved[name] = list(zip(gprompts.tolist(), toks.tolist()))
        res.update(weights=wfmt, fused=fuse, kv_quant=kvq, launches=counts,
                   weight_bytes=param_bytes(qp), peak_extra_bytes=peak)
        res["tok_s_ceiling"] = 8 / (res["weight_bytes"] / HBM_BYTES_PER_S)
        if tok_s > res["tok_s_ceiling"]:
            raise AssertionError(f"path {name}: {tok_s:.0f} tok/s exceeds "
                                 f"its ceiling {res['tok_s_ceiling']:.0f}")
        what = (f"engine 8 requests x 32 tokens in {res['engine_batch_s']:.3f}"
                f" s (admission {res['engine_admit_s']:.3f} s), lone request "
                f"{res['lone_request_s']:.3f} s" if name == "a" else
                f"generate B=8 S=128 x 32 in {res['generate_s']:.3f} s")
        print(f"path ({name}) {wfmt}{' fused' if fuse else ''} weights, "
              f"{kvq} KV: {what} = {tok_s:.1f} tok/s; ceiling "
              f"{res['tok_s_ceiling']:.0f} tok/s; params "
              f"{res['weight_bytes'] / 2**30:.2f} GiB, caches and "
              f"activations at peak {peak / 2**30:.2f} GiB", flush=True)
        print(f"  launches: {counts}")
        report["paths"][name] = res

    # the paged paths: (d) dense fused bf16 params over bf16 pools, one page
    # short of what the requests grow to (their padded prompts fill it at
    # admission, and the 228-token prompt crosses into its third page on the
    # way to 32 tokens), so the youngest sequence is preempted and recomputed;
    # (e) path (a)'s packs over e4m3 pools, the full default pool. Replayed
    # with the unfused params (d) / the same packs (e) over a contiguous cache.
    admit_pages = sum(pad(int(n)) // PAGE for n in plens)
    paged_paths = {
        "d": (fparams, None, admit_pages + 1, params,
              "dense fused bf16 weights, bf16 pools"),
        "e": (qparams["a"], QUANT_PATHS["a"][2], None, qparams["a"],
              "fp8 fused weights, fp8 pools")}
    for name, (pp, kvq, num_pages, _, label) in paged_paths.items():
        (res, toks), counts, peak = drive(name, lambda: serve_engine(
            pp, cfg, prompts, lone, max_new=32, max_seq=2048, bucket=bucket,
            kv_quant=kvq, paged=True, num_pages=num_pages))
        qserved[name] = list(zip(prompts + [lone], toks))
        res.update(kv_quant=kvq, page_size=PAGE, num_pages=num_pages,
                   launches=counts, weight_bytes=param_bytes(pp),
                   peak_extra_bytes=peak)
        res["tok_s_ceiling"] = 8 / (res["weight_bytes"] / HBM_BYTES_PER_S)
        if res["engine_tok_s"] > res["tok_s_ceiling"]:
            raise AssertionError(
                f"path {name}: {res['engine_tok_s']:.0f} tok/s exceeds its "
                f"ceiling {res['tok_s_ceiling']:.0f}")
        if name == "d" and res["preemptions"] < 1:
            raise AssertionError("path d: the short pool preempted nobody")
        print(f"path ({name}) paged Engine, {label}, pages of {PAGE}, pool "
              f"{num_pages or 'full'}: 8 requests x 32 tokens in "
              f"{res['engine_batch_s']:.3f} s (admission "
              f"{res['engine_admit_s']:.3f} s), lone request "
              f"{res['lone_request_s']:.3f} s = {res['engine_tok_s']:.1f} "
              f"tok/s; preemptions {res['preemptions']}; ceiling "
              f"{res['tok_s_ceiling']:.0f} tok/s; params "
              f"{res['weight_bytes'] / 2**30:.2f} GiB, pools "
              f"{res['kv_bytes'] / 2**20:.1f} MiB, pools and activations at "
              f"peak {peak / 2**30:.2f} GiB", flush=True)
        print(f"  launches: {counts}")
        report["paths"][name] = res

    # the chunk paths. Target of (f) and (h): path (d)'s dense fused bf16
    # params; draft: path (a)'s e4m3 pack of the same weights.
    draft = qparams["a"]
    (res, toks), counts, peak = drive("f", lambda: serve_engine(
        fparams, cfg, prompts, lone, max_new=32, max_seq=2048, bucket=bucket,
        paged=True, spec_k=SPEC_K, draft=(draft, cfg)))
    qserved["f"] = list(zip(prompts + [lone], toks))
    res.update(page_size=PAGE, spec_k=SPEC_K, launches=counts,
               peak_extra_bytes=peak)
    print(f"path (f) speculative paged Engine, spec_k {SPEC_K}, dense fused "
          f"bf16 target over bf16 pools, fp8 draft: 8 requests x 32 tokens "
          f"in {res['engine_batch_s']:.3f} s (admission "
          f"{res['engine_admit_s']:.3f} s), lone request "
          f"{res['lone_request_s']:.3f} s = {res['engine_tok_s']:.1f} tok/s; "
          f"acceptance {res['acceptance_rate']:.3f} ({res['accepted']} of "
          f"{res['proposed']}), {res['tokens_per_tick']:.2f} tokens per tick "
          f"over the batch; kv_memory {res['kv_memory']}; pools, draft cache "
          f"and activations at peak {peak / 2**30:.2f} GiB", flush=True)
    print(f"  launches: {counts}")
    report["paths"]["f"] = res

    prefix = rng.integers(0, cfg.vocab_size, PREFIX_LEN).tolist()
    waves = [[rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
             for lens in PREFIX_WAVES]
    (res, toks), counts, peak = drive("g", lambda: serve_prefix_waves(
        draft, cfg, prefix, waves, max_new=32, kv_quant=QUANT_PATHS["a"][2],
        chunk=PREFILL_CHUNK, bucket=bucket))
    g_tails = list(zip(waves[0] + waves[1], toks))
    res.update(page_size=PAGE, prefill_chunk=PREFILL_CHUNK, launches=counts,
               peak_extra_bytes=peak)
    w1, w2 = res["waves"]
    print(f"path (g) prefix-cached Engine, prefill_chunk {PREFILL_CHUNK}, "
          f"fp8 fused weights, fp8 pools: wave 1 (prefix {PREFIX_LEN} + "
          f"{list(PREFIX_WAVES[0])}) {w1['ticks']} ticks, all live after "
          f"{w1['all_live_s']:.3f} s, done in {w1['total_s']:.3f} s, "
          f"{w1['fill_and_decode_ticks']} ticks filled and decoded; wave 2 "
          f"(+ {list(PREFIX_WAVES[1])}) {w2['ticks']} ticks, all live after "
          f"{w2['all_live_s']:.3f} s, done in {w2['total_s']:.3f} s, "
          f"{w2['prefix_pages_hit']} prefix pages adopted; hits "
          f"{res['prefix_pages_hit']}, prefilled "
          f"{res['prefix_pages_prefilled']}, cached "
          f"{res['prefix_pages_cached']}; {res['tok_s']:.1f} tok/s; pools "
          f"{res['kv_bytes'] / 2**20:.1f} MiB, pools and activations at peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    print(f"  launches: {counts}")
    report["paths"]["g"] = res

    (res, h_gtoks, toks), counts, peak = drive("h", lambda: serve_speculative(
        fparams, draft, cfg, gprompts, 32, SPEC_K, prompts[:4], 32, bucket))
    qserved["h"] = list(zip(prompts[:4], toks))
    res.update(spec_k=SPEC_K, launches=counts, peak_extra_bytes=peak)
    eng = res["engine"]
    print(f"path (h) speculative_generate B=8 S=128 x 32, k {SPEC_K}, "
          f"contiguous bf16: {res['generate_s']:.3f} s = "
          f"{res['generate_tok_s']:.1f} tok/s, acceptance "
          f"{res['generate_acceptance_rate']:.3f}; speculative Engine, int8 "
          f"KV, 4 requests x 32 in {eng['engine_batch_s']:.3f} s = "
          f"{eng['engine_tok_s']:.1f} tok/s, acceptance "
          f"{eng['acceptance_rate']:.3f}; sampled (temperature 0.8, top_k "
          f"50) 2 x 8 tokens in {res['sample_s']:.3f} s, acceptance "
          f"{res['sample_acceptance_rate']:.3f}", flush=True)
    print(f"  launches: {counts}")
    report["paths"]["h"] = res
    phase_done("serving_paths")

    # path (i): training, on its own full-width params (seed 2); first the
    # replayed B=2 step against the plain attention, then the steps
    tparams = init_params(torch.Generator(device="cuda").manual_seed(2), cfg,
                          device="cuda")
    corpus = train_corpus(cfg.vocab_size, 200_000, seed=0)
    trng = np.random.default_rng(3)
    t_replay = time.perf_counter()
    replay = replay_train_step(cfg, tparams, crops(corpus, trng, REPLAY_B,
                                                   TRAIN_S, "cuda"))
    replay["seconds"] = time.perf_counter() - t_replay
    print(f"path (i) replayed step B={REPLAY_B} S={TRAIN_S}: loss "
          f"{replay['loss_kernels']:.6f} through the kernels, "
          f"{replay['loss_plain']:.6f} through the plain attention (relative "
          f"{replay['loss_rel_err']:.2e}, tol {REPLAY_LOSS_TOL}); worst "
          f"gradient relative L2 {replay['worst_grad_rel_l2_plain']:.2e} "
          f"({replay['worst_grad_plain']}, tol {REPLAY_GRAD_TOL}); against "
          f"the kernel forward with the plain backward "
          f"{replay['worst_grad_rel_l2_plain_bwd']:.2e} "
          f"({replay['worst_grad_plain_bwd']}, tol {REPLAY_BWD_TOL}), "
          f"roundoff floor {replay['worst_grad_rel_l2_nudged']:.2e}; "
          f"backward kernels per layer on its activations "
          f"{replay['worst_call_rel_l2']:.2e} at worst (tol "
          f"{REPLAY_CALL_TOL}) in {replay['seconds']:.1f} s", flush=True)
    (res, train_step, opt, last_batch), counts, peak = drive(
        "i", lambda: train(cfg, tparams, corpus, trng))
    res.update(replay=replay, launches=counts, peak_extra_bytes=peak,
               peak_bytes=torch.cuda.max_memory_allocated(),
               corpus_distinct_tokens=int(np.unique(corpus).size))
    print(f"path (i) training, make_train_step remat, AdamW lr {TRAIN_LR}, "
          f"B={TRAIN_B} S={TRAIN_S}, {res['n_params'] / 1e9:.3f}B params: "
          f"losses {[round(x, 4) for x in res['losses']]}; after "
          f"{TRAIN_WARMUP} warm-up steps {res['step_s']:.4f} s a step = "
          f"{res['tok_s']:.1f} tok/s, model-FLOP share "
          f"{res['model_flop_share']:.4f} of {BF16_FLOP_PER_S / 1e12:.0f} "
          f"TFLOP/s; peak device memory {res['peak_bytes'] / 2**30:.2f} GiB "
          f"({peak / 2**30:.2f} GiB above the resident params of every "
          f"path); corpus cycle {res['corpus_distinct_tokens']} tokens",
          flush=True)
    print(f"  launches: {counts}")
    report["paths"]["i"] = res
    phase_done("training_path")

    # 5. teacher-forced checks against solo replays
    t3 = time.perf_counter()
    graphs = {}  # a StepGraphs per (params, cache type)

    def graphed(p, kvq):
        if (id(p), kvq) not in graphs:
            graphs[id(p), kvq] = StepGraphs(p, cfg, kvq)
        return graphs[id(p), kvq]

    gaps = check_served(params, cfg, prompts + [lone], served, gprompts,
                        gtoks, graphed(params, None))
    replay_of = {**{name: (qparams[name], kvq)
                    for name, (_, _, kvq) in QUANT_PATHS.items()},
                 **{name: (rp, kvq)
                    for name, (_, kvq, _, rp, _) in paged_paths.items()},
                 "f": (params, None), "h": (params, "int8")}
    for name, (rp, kvq) in replay_of.items():
        for i, (prompt, toks) in enumerate(qserved[name]):
            gaps[f"{name}/{i}"] = replay_gap(rp, cfg, prompt, toks, kvq,
                                             graphed(rp, kvq))
    for b, toks in enumerate(h_gtoks.tolist()):
        gaps[f"h/generate{b}"] = replay_gap(params, cfg, gprompts[b].tolist(),
                                            toks, None, graphed(params, None))
    replay_of["g"] = (draft, QUANT_PATHS["a"][2])
    for i, gap in enumerate(stepwise_gaps(graphed(*replay_of["g"]), prefix,
                                          g_tails)):
        gaps[f"g/{i}"] = gap
    graphs.clear()
    # a graph replays into its stream's scratch after the stream grew it:
    # (b)'s int8 packs over an int8 cache (split-K w8a16, split-KV decode)
    report["graph_scratch"] = graph_scratch_check(
        qparams["b"], cfg, QUANT_PATHS["b"][2])
    print(f"graph scratch: a captured B=1 step replayed bit for bit after "
          f"its stream's buffers grew {report['graph_scratch']}", flush=True)
    worst = {p: max(g for k, g in gaps.items()
                    if k.split("/")[0] in ((p,) if p != "bf16"
                                           else ("engine", "generate")))
             for p in ("bf16", *replay_of)}
    report["teacher_forced"] = {"tol": LOGIT_TOL, "worst": worst,
                                "gaps": gaps,
                                "seconds": time.perf_counter() - t3}
    print(f"teacher-forced: worst gap by path {worst} (tol {LOGIT_TOL}) "
          f"over {len(gaps)} streams in {time.perf_counter() - t3:.1f} s",
          flush=True)
    if max(worst.values()) > LOGIT_TOL:
        raise AssertionError(f"served tokens off the solo replay: {gaps}")
    # greedy speculative decoding is exact up to bf16 near-ties between the
    # T-row verify and the one-row decode: printed, not asserted
    plain_g = generate(fparams, cfg, gprompts, 32)
    report["equal_to_plain_greedy"] = {
        "f_vs_d": float(np.mean([a == b for (_, ta), (_, tb) in zip(
            qserved["f"], qserved["d"]) for a, b in zip(ta, tb)])),
        "h_vs_generate": float((h_gtoks == plain_g).float().mean())}
    print(f"share of tokens equal to plain greedy decoding: "
          f"{report['equal_to_plain_greedy']}")
    prompt512 = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, 512)).astype(np.int32)).cuda()
    report["vs_bf16"] = {name: agreement(params, qparams[name], cfg,
                                         prompt512)
                         for name in QUANT_PATHS}
    print(f"quantized forward vs bf16 (512-token prompt): "
          f"{report['vs_bf16']}")

    phase_done("checks")

    # 6. where a decode step's time goes
    # (bf16 against bf16_fused is the fused kernel's A/B: the same step,
    # the same contiguous cache, unfused against dense fused params)
    report["profile"] = {
        "bf16": profile_decode(params, cfg, batch=8, context=1024),
        "bf16_fused": profile_decode(fparams, cfg, batch=8, context=1024),
        "d": profile_decode(fparams, cfg, batch=8, context=1024, paged=True),
        "a": profile_decode(qparams["a"], cfg, batch=8, context=1024,
                            kv_quant=QUANT_PATHS["a"][2])}
    print_profile("bf16, unfused params", report["profile"]["bf16"])
    print_profile("bf16, dense fused params (fused norm->QKV->RoPE)",
                  report["profile"]["bf16_fused"])
    print_profile("(d) dense fused params, paged bf16 pools",
                  report["profile"]["d"])
    print_profile("(a) fp8 weights + fp8 KV", report["profile"]["a"])
    report["profile"]["f_tick"] = profile_verify_tick(
        fparams, draft, cfg, batch=8, context=1024, k=SPEC_K)
    print_profile(f"(f) {SPEC_K} fp8 draft steps + catch-up + T={SPEC_K + 1} "
                  "verify over paged bf16 pools", report["profile"]["f_tick"],
                  what="speculative tick")
    report["profile"]["i_step"] = {
        "batch": TRAIN_B, "context": TRAIN_S, **profile_run(
            lambda: (train_step(tparams, opt, last_batch), sync(tparams[
                "embed"].device)), 1, TRAIN_CLASSES)}
    print_profile("(i) remat, AdamW", report["profile"]["i_step"],
                  what="training step")
    print(f"  device ms by class: "
          f"{report['profile']['i_step']['device_ms_by_class']}")

    phase_done("profiles")
    print(f"phase seconds: {phase_s}")
    kernels = {}
    for r in checks.values():  # first check of a kernel is its row
        row = kernels.setdefault(r["name"], dict(r))
        row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
    for name, row in kernels.items():
        row["launches"] = sum(p["launches"].get(name, 0)
                              for p in report["paths"].values())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{k: r[k] for k in keys} for r in kernels.values()]}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        report.pop("partial", None)  # the paths hold it now
        Path(args.json).write_text(json.dumps({**report, **line}, indent=1,
                                              default=str))
    print(json.dumps({k: jres["headline"][k] for k in (
        "hgemm_bf16_8192cubed_tflops", "cublas_tflops", "ratio", "card")}))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": 1}}))
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
