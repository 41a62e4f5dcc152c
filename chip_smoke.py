"""Chip smoke for the PyTorch/CUDA port (``apex_tpu_torch``) on one H100.

Run from the repository root on a machine with the card::

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero:

1. device — name, count, compute capability (must be (9, 0)) and the
   card's power limit as ``nvidia-smi`` reports it;
2. build — every ``apex_tpu_torch/csrc/*.cu`` compiled by ``nvcc`` for
   ``sm_90a`` into the build directory, with ``-Xptxas -v``'s report;
3. kernels vs plain — each kernel against its plain PyTorch version on
   the card at the serving path's shapes, with CUDA-event timings of the
   kernel, the plain version and one PyTorch library call computing the
   same function (for the column write, one ``index_put_`` of the same
   cells), and the least time the card could take (bound); bf16 flash
   prefill runs the tensor-core kernel (``csrc/flash_fwd_tc.cu``), fp32
   the CUDA-core one, each held to its launch counter; the decode step's
   fused launch (``decode_attention``: the column write inside the split
   read's launch) at the 355M's serving shape and the 2.7B's decode shape
   (8 rows of 32 heads of 80, horizon 1024) in fp32, bf16 and fp16, at
   every split's first and last column, 0, the horizon's last column and
   one past it: caches and out bit-equal to ``write_column`` then
   ``attend_cache`` on a copy of the same caches, and the caches bit-equal
   and out within DECODE_TOL of the plain twin; timed in bf16 beside the
   pair, the write alone and the read alone (no library call does both);
4. whole model — GPT 355M (24 layers, hidden 1024, 16 heads, vocab
   50304, bf16, random weights from a seed): prefill + decode logits
   through the kernels against the materialised-scores ("xla") path;
5. the path — ``Scheduler(Engine(...))`` answers bench.py's 32-request
   trace (8 slots, horizon 192); the kernels' launch counters must show
   that flash prefill (on the tensor-core kernel) ran for every layer of
   every admission group and the fused decode step
   (``decode_attention_write``) L x decode steps times, with no
   stand-alone single-column write or read (``decode_write_column``,
   ``decode_attention``, ``paged_write_column``, ``paged_attention``) nor
   quantized one; and every stream is held against a teacher-forced
   forward without kernels;
6. profile — ``torch.profiler`` over a window of decode chunks: the
   device's busy share, the kernels that take its time, per decode step
   the host's ms, the kernels launched (CUDA API calls and device records)
   and the idle share, and the decode reads' device time and calls (the
   split read's plain and quantized instantiations apart; every plain one
   a launch of the fused write + read counted in the window, no
   stand-alone single-column write or read, no replaced quantized kernel).

The serving engine and weights are freed; then the training slice:

7. training kernels vs plain — flash forward and backward at the train
   step's shapes (b=16, s=1024, hidden 1024, 16 heads, bf16, causal),
   the backward also at ragged small shapes in fp32 and bf16 (bf16 on
   the tensor-core backward, ``csrc/flash_bwd_tc.cu``, held to
   BWD_TC_TOL against the twin that rounds P and dS as JAX does, with the
   CUDA-core bf16 kernel measured and timed beside it), and
   ``adam_flat`` on one fp32 group of the 355M model's padded size (and
   a small bf16 group, with and without ``skip``), timed as in phase 3;
8. gradients — one gradient of the training loss at 355M width, batch 4,
   through the kernels (bf16) and through the "xla" attention in bf16
   and fp32 (the reference): the kernel path's error must stay within 3x
   the bf16 "xla" path's;
9. the train step — bench.py main()'s 355M step (batch 16, seq 1024,
   remat_policy="qkv_fc1_attn", ce_chunk 512, bf16, flash) through
   ``make_train_step``, one warm-up and 10 timed steps with
   ``fused_adam(1e-4, layout="flat")`` and then with ``layout="tree"``:
   tokens/s, step time, peak memory and every step's loss, and per step
   24 launches of flash forward and of flash backward (every one on the
   tensor-core kernels), and one of
   ``adam_flat`` (flat) or none (tree);
10. profile — ``torch.profiler`` over 2 train steps of each layout:
    device time per step by kernel category, and the packing's share.

Then the BERT slice (``examples/bert_pretrain.py``'s trainer at
BERT-large width: vocab 30528, hidden 1024, 24 layers of 16 heads, seq
512, full remat, bf16, FusedLAMB):

11. BERT kernels vs plain — the LayerNorm forward and backward at
    [16384, 1024] bf16 with fp32 w/b and at a ragged [37, 513] fp32
    (dw/db bit-equal across two launches), ``l2norm_flat`` (bit-equal
    across launches; its tails in fp32 and bf16 at n = 1, 7, 4097, a
    tile +- 4 and several tiles a block, five mixed buffers and more
    buffers than one launch takes, all against the plain twin; one
    kernel and its ticket's memset a call, by ``torch.profiler``; timed
    in fp32 and bf16) and ``adam_flat`` in delta mode (p untouched) on
    the 335.2M model's padded fp32 group, and the flash forward and backward
    with ``causal=False`` at b=32 s=512 (the backward also in fp32 at
    b=2, 8 key tiles), timed as in phase 3;
12. BERT gradients — one ``mlm_loss`` gradient at batch 4 through the
    kernels (bf16, ``ln_impl="pallas"``), the "xla" attention and
    LayerNorm in bf16, and in fp32: the kernel path within 3x the bf16
    "xla" path's error;
13. the BERT step — ``make_mlm_train_step`` at batch 32 of seq 512, one
    warm-up and 10 timed steps, run (a) ``fused_lamb(layout="flat")``
    with ``ln_impl="pallas"`` (every kernel) and run (b) the example's
    own choice (tree LAMB, the "xla" LayerNorm in the blocks): tokens/s,
    step time, peak memory, every loss, and per step the launches the
    code implies (``bert_launches_per_step``);
14. profile — ``torch.profiler`` over 2 steps of run (a).

The paged KV cache and speculative decoding run on phases 4-6's serving
model, right after phase 6 (numbered after the slices that came before):

15. paged and speculative kernels vs plain — ``paged_write_column``,
    ``paged_write_columns`` and ``cache_write_columns`` bit-equal to their
    plain versions (lanes past the horizon and positions 0, 7, 8 and 191
    included, tables a random permutation of pages 1..192, every unwritten
    pool cell and the sink page NaN), ``paged_attention`` within BF16_TOL
    of its plain version, finite, and bit-equal to ``decode_attention`` on
    the gathered cache; timed as in phase 3, the writes' library yardstick
    one ``index_put_`` of the same cells of both planes, the read's none;
    the paged fused launch (``paged_decode_attention``) held as phase 3
    holds the contiguous one, pages of 8 at both shapes, against
    ``paged_write_column`` then ``paged_attention`` and the plain twin, and
    timed the same way; the speculative verify's launch
    (``decode_verify_attention``, ``paged_verify_attention``: the
    multi-column write inside a split read of T query rows) at both shapes
    in fp32, bf16 and fp16 with T 4 and 8, at ``fused_positions`` and a set
    whose lanes pass the horizon: caches bit-equal to
    ``cache_write_columns`` / ``paged_write_columns`` alone, every query
    row bit-equal to the single read at its position, paged out bit-equal
    to contiguous, out within DECODE_TOL of the plain twin; timed in bf16
    at T 4 beside the parent's pair (the write, then the materialised
    read), the write alone, SDPA with a [b, 1, T, S] mask (the read's
    library call) and the plain twin;
16. paged serving — (a) phase 5's trace through ``EngineConfig(...,
    page_size=8)`` (193 pages, auto-sized): every stream identical to phase
    5's, and per decode step 24 launches of the paged fused write + read
    (``paged_attention_write``) and none of any other single-column decode
    kernel; (b) bench's mixed trace at
    ``decode_chunk=8`` with a 25-page pool against the contiguous engine:
    admissions held back for pages, every request complete and within the
    reference band, the pool's peak and the cache bytes pinned per active
    token;
17. speculative serving — bench's spec A/B (8 slots, prompts <= 16,
    horizon 192, chunks of 4, ``spec_k=3`` against ``spec_k=0``; 16
    requests of 96 tokens, greedy "high" and temperature-1.5 "adv"
    traces) under the scheduler's payoff gate: every spec stream within
    the reference band, the verify launch (``decode_verify_attention``)
    on every layer of every verify wave and no stand-alone
    ``cache_write_columns``; drift against plain, tokens per wave, the gate's
    decisions and decode tokens/s reported;
18. paged + speculative — the "high" trace with every chunk speculative
    (``admit_many`` and ``step_async(spec=True)``, no scheduler) through a
    paged and a contiguous spec engine: identical tokens, each side's
    verify launch (``paged_verify_attention``, ``decode_verify_attention``)
    on every layer of every wave, no stand-alone multi-column write, and
    no single-column read, fused or not, anywhere.

Prefix reuse and long prompts run next, on the same serving model
(numbered after the slices that came before):

36. prefix pool, copy-on-write, chunked prefill, pipelining — bench's
    prefix A/B (prompts <= 128, horizon 144, chunks of 8, a 64-token
    template with tails of 1-8 tokens, 32 requests of 8 tokens, at
    ``pipeline_depth=2, max_admit_batch=1``): a pool of one template
    against cold prefill, in alternating rounds, the hit and cold TTFT
    and the median of the per-round ratios, 32 hits (a tail extend each,
    no flash prefill) against 32 cold admissions (row 5 on every layer),
    reruns identical, the hit streams within the reference band and any
    hit/cold divergence at a top-2 gap within it; copy-on-write at pages
    of 8 (two waves, each bit-identical to the pooled hits,
    ``page_share_hits == prefix_hits``, the pinned prefix pages
    bit-unchanged by the paged decode launches, only they in use after
    the drain), the same with ``spec_k=3`` (the paged verify launch on
    every layer of every wave, the pinned pages unchanged) and with an
    int8 cache (pooled == copy-on-write); bench's chunked A/B (one
    256-token prompt in chunks of 64 ahead of 7 short ones, horizon 288):
    the shorts' TTFT inflation over a shorts-only run, monolithic against
    chunked, ``chunked_admissions`` 1 and ``chunked_chunks`` 4, row 5 for
    every cold group and chunk 0; phase 5's trace at depth 1 and 2:
    identical streams, the host ms a decode step on each side. Every
    decode path launches its fused entries and no stand-alone
    single-column write or read.

The serving front end runs next, on the same serving model (prompts up
to 128, which byte-level chat prompts need where ``serve()`` admits 64;
horizon 192, 8 slots, ``decode_chunk=1``):

37. the OpenAI front end — ``start_api_server`` on 127.0.0.1 (port 0)
    over an ``Engine`` and a ``Scheduler`` at ``pipeline_depth=2,
    max_admit_batch=1`` with tenants, driven through ``http.client``:
    (a) eight concurrent greedy streamed chats, each SSE stream equal to
    the solo ``gpt.generate`` or parting at a reference near-tie within
    the band; (b) ``/v1/completions`` with stop strings cut from each
    prompt's unstopped stream (two plain, two ``json_object``): the
    output is the reference trim, ``finish_reason`` "stop"; (c) four
    ``json_schema`` requests at once: each output parses and fits its
    schema, mask uploads counted; (d) 16 + 16 streamed requests of two
    tenants at weights 3:1: each tenant's share of the first half of the
    streamed tokens, every stream equal to the same requests served by
    one tenant, a 429 with ``Retry-After`` for a tenant over its token
    budget; (e) ``draw_slots`` on the card: all-True masks bit-equal to
    none, a one-token whitelist forced, the greedy masked draw the
    argmax; (f) phase 6's window on this engine without and with one
    constrained slot, in turns: launches and host ms a decode step, the
    unconstrained launches equal to phase 6's. Row 5 on every layer of
    every admission and the fused decode step on every layer of every
    decode step, counted over (a)-(d).
38. beam search and multi-LoRA — (a) ``gpt.beam_search`` over two
    32-token prompts, 32 new tokens: one beam equals the greedy
    ``generate``; at 4 beams (a decode batch of 8) the beams are sorted,
    each score is its teacher-forced total log-probability, a frozen
    beam emits only pad after an eos that fires and keeps its score;
    launches and host ms a beam step, the reorder's launches; (b) a
    ``Scheduler`` over an ``Engine`` with an adapter pool (serve()'s
    geometry, ``max_admit_batch=1``, adapters of seeds 7 and 9 at rank 8,
    alpha 16) on 24 greedy requests over adapters ``i % 3``: base rows
    bit-equal to a pool-less engine, each adapter's requests alone equal
    to the mixed run, adapter streams equal to ``generate`` over
    ``merge_lora`` up to reference near-ties, phase 6's window with base
    rows only (phase 6's launches a decode step) and with adapter rows,
    in turns; (c) a paged ``spec_k=3`` pool engine: rows 13 + 17 and 15v
    on every layer, streams equal to (b)'s up to near-ties; (d)
    ``/v1/models`` lists the adapters and a chat naming one returns the
    scheduler's stream; (e) ``examples.generate --beams 4``. Launches of
    rows 5, 10, 17 and 15v counted in (a), (b) and (c).
39. the host-swap tier — serve()'s paged geometry with ``host_swap``, 16
    requests of 48 tokens (half seeded-sampled): (a) every active
    conversation parked two ticks in and resumed two ticks later, under
    ``swap``, ``recompute`` and ``auto``, against the uninterrupted run
    on the same engine: swap-resumed streams bit for bit, re-derived and
    re-batched ones up to reference near-ties (counted), each request's
    streamed tokens equal to its completion's (or parting at such a tie,
    counted); (b) int8 with ``spec_k=3`` under ``swap``, the parked
    streams bit for bit;
    (c) a pool of 1 + 3 x 24 pages, three tenants, ``preempt=True``:
    preemptions, natural finishes; (d) a host tier of 24 pages under
    ``spec_k=3``: capacity drops and recompute resumes; (e) two adapter
    rows serving 4 adapters against a 5-row pool; (f) the bytes a parked
    page, the swap's host ms a page against a pinned ``copy_`` of the
    same bytes, and a decode step's launches on the churned engine
    against a fresh one's. Launches of rows 5, 13 + 17, 15v, 14 + 18 and
    16 counted over (a)-(e).
40. serving telemetry and the self-tuning scheduler — (a) serve()'s
    contiguous engine with ``decode_chunk`` 4 on the ladder (1, 2, 4, 8)
    under ``TunerConfig(decode_chunk=(1, 2, 4, 8), pipeline_depth=(1,
    2))``, every sink on (registry, spans, flight recorder, SLO
    objectives, a metrics logger): bench's trace back to back until each
    knob has ended a probe window, every stream the base point's (no
    tuner) up to reference near-ties (counted), the decisions printed;
    (b) the paged engine with ``spec_k=3``, ``spec_ks=(3,)`` and the
    tuner owning ``spec_k`` over (0, 3), no payoff gate: 16 requests of
    48 tokens, streams the plain engine's up to near-ties, rows 13 + 17
    and 15v counted; (c) (a)'s engine at rung 1, a decode step with every
    sink on against one with none, in turns (4 windows each): the
    launches a step equal on both sides and to phase 6's (hard), host ms
    and idle share printed; (d) the bundle of (a)'s last trace:
    ``replay_tuner`` and ``replay_slo`` reproduce every decision and
    alert bit for bit (hard), ``replay_bundle`` rebuilds the 355M from it
    on the card and replays the trace (partings at near-ties counted),
    ``render_report`` renders it; (e) ``MetricsServer`` on 127.0.0.1:0
    scraped mid-run and at the end (requests, tokens and tuner switches
    against ``summary()`` and the recorder), and one request through
    ``start_api_server(..., registry=...)`` with ``/slo`` answering 200.

The quantized KV cache (``kv_cache_dtype="int8"`` / ``"fp8"``: a byte a
value beside an fp32 scale per head row and column) runs next, on the
same serving model:

19. quantized kernels vs plain — ``write_column_quant``,
    ``cache_write_columns_quant``, ``paged_write_column_quant`` and
    ``paged_write_columns_quant`` bit-equal to their plain versions in
    the data and the scale planes (int8 and fp8, bf16 rows and once fp32,
    positions 0, 7, 8 and 191, lanes clamped past 191), ``attend_cache_quant``
    and ``paged_attention_quantized`` within BF16_TOL (FP32_TOL for fp32
    q) of plain, finite over planes whose stale cells hold fp8 NaN bytes
    (or int8 -128) and NaN scales, the paged read bit-equal to the
    contiguous read on the gathered planes; timed as in phase 3, int8
    in the rows with fp8 beside it; no library yardstick (none exists);
20. quantized serving — the decode logits of phase 4's inputs through
    the int8 and fp8 caches within JAX's ``_KV_TOL`` of the compute
    cache's (fp32 compute); bench's KV-cache A/B #1 on phase 5's trace at
    ``decode_chunk=8``, int8 against the compute cache in turns (int8,
    compute, compute, int8), serial where bench pipelines (depth 2):
    cache bytes per slot (10,027,008 vs 18,874,368) and ``bytes_ratio``
    1.882, decode tokens/s, each side's idle share, and per decode step
    24 launches of the quantized write and read and none of the compute
    cache's; the trace once with fp8, once paged int8 (streams identical
    to contiguous int8; pools 80,633,856 vs 151,781,376 bytes), and int8
    and fp8 through ``decode_attn_impl="xla"``: every kernel-side stream
    identical, or first diverging at a reference top-2 gap within the
    band; phase 17's "high" trace with int8 at ``spec_k=3`` against int8
    plain (tokens per wave, drift), and with every chunk speculative
    through a paged and a contiguous int8 spec engine (identical streams,
    ``paged_write_columns_quant`` on every layer of every wave).

The rest of single-chip training runs last, after the BERT phases:

21. xentropy and fp16 flash kernels vs plain — the fused cross entropy's
    forward (loss, lse) and backward (dx) at one CE chunk of the GPT step
    ([16 x 512, 50304] fp32, smoothing 0 and 0.1, every 7th row ignored,
    a target past the vocab) and at ragged shapes (V = 50257, unaligned
    bf16 rows of V = 300, V = 3); the flash forward and backward with
    float16 inputs at the BERT step's shape (b=32, s=512, non-causal) on
    the tensor-core kernels' fp16 instantiation, held to F16_TC_TOL /
    F16_BWD_TC_TOL against the twins that round P and dS to fp16, with
    the fp32 route on the widened inputs (what fp16 ran before) measured
    and timed beside; fp16's range: ``do`` scaled by the largest power of
    two at which the fp32 route's gradients stay finite in fp16, the
    kernel's gradients finite there, the largest |dS| logged; timed as in
    phase 3, the library yardsticks ``F.cross_entropy``'s forward and its
    backward (forward plus backward, less the forward) and fp16 SDPA;
22. the fused cross entropy in the train step — phase 9's tree-layout
    step with ``ce_impl="fused"``: losses within a band of phase 9's
    "xla" run (step 0 equal to fp32 rounding), per step 4 forward and 2
    backward xentropy launches (two chunks, each replayed by its
    checkpoint), step time and peak memory of both runs;
23. BERT in fp16 — ``examples/bert_pretrain.py --fp16``: BERT-large at
    ``compute_dtype=float16`` with tree LAMB and the scaler of
    ``amp.initialize("O2", half_dtype=float16)``; one step forced to
    overflow at a loss scale of 2^40 (skipped, params and LAMB state
    bit-equal, the scale halved and clamped to 2^24), then one warm-up
    and 10 timed steps from 2^16 with each step's scale and skip (none
    skipped), the loss falling over the applied steps, and the launches
    ``bert_launches_per_step`` implies (every flash launch on the
    tensor-core kernels); then ``torch.profiler`` over 2 steps;
24. ResNet-50 — ``sgd_flat`` against its plain version on the model's
    padded fp32 group (and bf16 groups with Nesterov, the delta mode and
    ``skip``), timed beside ``torch.optim.SGD``'s fused step; then
    ``examples/imagenet_amp.py``'s loop (depth 50, batch 64 of 224x224,
    bf16, ``amp.initialize("O1", half_dtype=bfloat16)``, lr 0.1, momentum
    0.9, weight decay 1e-4) with ``fused_sgd`` in the flat layout (one
    ``sgd_flat`` launch a step) and the example's tree layout: images/s,
    peak memory, the first update lowering the loss, the losses of the
    first 4 steps within a band of each other (step 0 equal), and the
    eval leg's top-1/top-5 on the batch.

The head-major flash attention runs last (Megatron-GPT 2.7B, the
``2p7b`` preset of ``apex_tpu_torch.examples.gpt_train``: vocab 50304,
hidden 2560, 32 layers of 32 heads of 80, seq 1024, full remat, bf16,
tree Adam, batch 8):

25. head-major kernels vs plain — the forward, the fused backward and the
    split dQ and dK/dV sweeps at small ragged shapes (fp32 and bf16, head
    widths 64, 80 and 128; causal s=200 and s=65 with segment ids, sq=72
    against sk=130 with kv lengths 0, 130, 57 and segment ids, an lse
    cotangent) and through the public API in fp16 with
    ``flash_attention_with_lse``'s lse cotangent (the tensor-core kernels
    at d 64, 80 and 128, held to F16_TC_TOL / F16_BWD_TC_TOL and timed
    beside the fp32 route and fp16 SDPA; d 100 widened to the fp32
    kernels; the split dQ sweep on fp16, widened), then at
    the 2.7B step's attention (b=8, 32 heads, s=1024, d=80, bf16,
    causal): every kernel within its tolerance of its plain version,
    fused == split where both run the CUDA cores, the split kernels
    bit-equal across two launches; the forward and fused backward on the
    tensor-core kernels in bf16 (d=32 and 72 too, and a q off a 16-byte
    boundary, after one copy; the backward held to BWD_TC_TOL against the
    rounding twin, the CUDA-core fused kernel measured beside it) and on
    the CUDA-core ones in fp32 and at d=100, rows whose segment id no key
    carries (out 0, lse -1e30 + log(1e-30)), and the CUDA-core bf16
    kernels timed beside the new ones at the 2.7B shape;
    timed as in phase 3, the library yardsticks SDPA's forward and its
    backward (forward plus backward, less the forward; for the split
    sweeps the backward asked for dq, or dk and dv, alone);
26. 2.7B gradients — one loss gradient at batch 1 through the head-major
    kernels (bf16), the "xla" attention in bf16 and in fp32 (the
    reference): the kernel path within 3x the bf16 "xla" path's error;
27. the 2.7B step — the example's ``build`` and ``train``: one warm-up
    and 5 timed steps (its ``--steps 5``) with the fused backward, then 3
    steps under ``APEX_TPU_FLASH_BWD=split``: tokens/s, step time, peak
    memory, every loss (finite, falling; split within a band of fused,
    step 0 equal), and per step 64 head-major forwards (full remat
    replays each layer's; all on the tensor-core kernel), 32 fused
    backwards or 32 dQ and 32 dK/dV
    sweeps, and no lane-packed launch; then phase 9's 355M tree step with
    ``attn_layout="bhsd"`` (1 + 3 steps) beside phase 9's lane-packed
    run: 24 head-major forwards and backwards a step, losses within a
    band;
28. profile — ``torch.profiler`` over 2 steps of the 2.7B (fused run):
    device ms per step by kernel category, the head-major kernels' share
    and the idle share.

The apex L3 surface runs last (the entry points apex users call from
their own loops, at the GPT-2 355M's widths):

29. L3 flat kernels vs plain — ``scale_flat``, ``axpby_flat`` and
    ``adagrad_flat`` on the 355M's padded fp32 group (354,877,440
    elements) and small bf16 and fp16 groups: scale and axpby bit-equal
    to plain, the found-inf flag raised by an inf input (scale) and an
    fp32 overflow (axpby) and not by an fp16 narrowing overflow; axpby
    also bit-equal in each of its 8 x/y/out dtype combinations at n =
    4 * 65537 (no multiple of its tile, and of 8), its flag raised by an
    fp32 overflow at the first and at the last element; adagrad within
    ADAM_TOL, its delta mode, a skipped sweep, and one step against
    ``torch.optim.Adagrad``; timed as in phase 3;
30. softmax kernels vs plain — the forward and backward at the 355M's
    unfused causal scores ([16, 16, 1024, 1024] bf16, scale 1/8) and
    BERT-large's padded ones ([32, 16, 512, 512] fp16 through the public
    API, fully masked rows included), and at odd shapes (sk 1000 and
    2500, sq != sk with a mask, the legacy mask, fp32), each forward on
    the route ``fwd_route`` names: the row-in-registers kernel (route 1)
    also causal bf16 at sk 8, 264 and 1000 and at sk = the cap, route 0
    at the cap + V and on a misaligned view, two launches bit-equal; both
    routes timed at the 355M and BERT shapes; then
    ``FusedScaleMaskSoftmax`` fused (2 forward and 2 backward launches,
    both forwards on route 1) against unfused, causal and padding;
31. the 355M trainer with FusedAdagrad — phase 9's step through
    ``make_train_step(cfg, fused_adagrad(1e-2, layout=...))``, flat then
    tree, 1 + 3 steps each: losses finite, the layouts within
    LAYOUT_LOSS_BAND (step 0 equal), one ``adagrad_flat`` launch a step
    (flat) or none (tree);
32. the apex L3 loop — per step two micro-batches of 8, each gradient of
    ``loss * 2^12`` by ``torch.autograd``, accumulated through
    ``MultiTensorApply`` with ``scale_flat`` and ``axpby_flat``,
    ``clip_grad_norm_(acc, 1.0)``, a flat FusedAdagrad step with the
    overflow flag as ``skip``: 1 + 3 steps, losses falling, per step 2
    scale, 1 axpby, 1 l2norm and 1 adagrad launches; then a step with an
    inf gradient, skipped with params and h bit-equal.

The decode reads at every head width run right after phase 19, on the
same serving model, and Megatron-GPT 2.7B is served right after phase 28
(the 2.7B step's state freed first):

33. decode reads at any width — ``attend_cache``, ``paged_attention``,
    ``attend_cache_quant`` and ``paged_attention_quantized`` at head
    widths 32, 80, 100 and 128 (8 rows of 4 heads, horizon 192, NaN and
    stale bytes past every position and in the sink) against their plain
    versions: fp32, bf16 and fp16 caches, int8 and fp8 planes with q in
    each of the three, within DECODE_TOL, and the paged reads bit-equal
    to the contiguous ones; the fp16 column writes (plain and quantized)
    bit-equal to theirs; the four reads (all of them instantiations of
    the one split read) at every width, dtype and storage kind over a
    horizon of 200 (no split count divides it) with positions on the
    edges of ``read_splits``' splits, held the same way, the paged read
    at pages of 1, 8, 25 and 40 columns, and a second launch of each
    bit-equal to the first; then each read at the 2.7B's decode shape
    (b=8, 32 heads of 80, horizon 1024, positions 127..1023), held,
    launched twice (bit-equal) and timed as in phase 3, row 10 beside
    SDPA (the reads alone: the fused write + read at that shape is held
    and timed in phases 3 and 15);
34. the 2.7B served — weights in bf16 from seed 0 (5.3 GB); phase 4's
    cross-check at its width in bf16 and fp16 (``compute_dtype=float16``,
    the fp16 decode kernels) and phase 20's quantized logits (fp8 held
    against its own "xla" read: at 32 layers its rounding leaves JAX's
    KV_TOL); then bench's
    32-request trace through ``Scheduler(Engine(...))`` contiguous, paged,
    int8, paged int8 and speculative (``spec_k=3``): every decode step's
    fused write + read (contiguous, paged, and spec's plain chunks) or
    quantized write and read (int8, paged int8) on every layer and no
    other single-column decode kernel, head-major prefill on the
    tensor cores, paged streams == contiguous and paged int8 == int8, int8
    and spec streams equal to contiguous up to reference near-ties (phase
    20's rule); decode tokens/s, TTFT and peak memory per side;
35. profile — phase 6's window over the 2.7B's contiguous engine, and
    over its int8 engine: the device's idle share, the host's ms and the
    launches a decode step, and the decode reads' device time, the split
    read's plain and quantized instantiations apart (the contiguous
    engine's plain ones all fused launches, the int8 engine runs only
    quantized ones), and no launch of the one-block-a-row quantized
    kernels they replaced.

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are the card's time
per call, from CUDA graphs of back-to-back calls replayed between CUDA
events; ``eager_ms`` is the same kernel launched from Python, the
wrapper's host cost included. ``library_ms`` is one PyTorch call that
computes the same function: ``F.scaled_dot_product_attention`` (the
flash forwards'), its forward plus backward less its forward (the flash
backwards'),
``F.layer_norm``'s forward plus backward less its forward (the LayerNorm
backward's), ``torch.optim.AdamW(fused=True)``'s step on one flat tensor
(Adam's), ``F.cross_entropy``'s forward plus backward less its forward
(the xentropy backward's), ``torch.optim.SGD``'s fused (or foreach)
step on one flat tensor (SGD's), amp's
``torch._amp_foreach_non_finite_check_and_unscale_`` (scale's),
``torch.add(y, x, alpha=a)`` (axpby's), ``torch.optim.Adagrad``'s
foreach step (Adagrad's), and ``torch.softmax`` and
``torch._softmax_backward_data`` on already scaled and masked scores
(the softmax kernels'; they leave out the scale and the mask).

The line before the last is ``{"kernels": [...]}`` (34 entries: the 30
kernels, the two fused decode steps, ``decode_attention_write`` and
``paged_attention_write``, each with its time, the write + read pair's
(``pair_ms``), the write's and the read's alone in the same call, its
cases held bit-equal to the pair, its launches on phase 5's or 16's path
and a ``2p7b`` entry with phase 34's, and the two verify launches,
``decode_verify_attention`` and ``paged_verify_attention``, each with its
time, the parent's write + materialised read (``pair_ms``), the write's
alone, SDPA's (``library_ms``), its cases held, its launches on phase
17's or 18's path and a ``2p7b`` entry; rows 7, 10, 13 and 17 run on the
main path inside the fused decode launches, rows 8 and 15 inside the
verify launches, so their ``launches`` are those launches', their own
wrappers' beside as ``standalone_launches`` (0 on every serving path)
and ``main_path`` naming the launch; the
two flash forwards' and the two fused flash backwards' rows name their
kernel as ``variant``, with the tensor-core launches as
``launches_tc``; the head-major forward's and both backwards' carry the
CUDA-core kernel's bf16 time on the same inputs as ``prev_ms``, the
backwards' also the BWD_TC_TOL measurements as ``tol``; the four flash
rows carry their fp16 entries under ``fp16``, each with the fp32
route's time on the same inputs as ``prev_ms``; the four decode reads
carry their entry at the 2.7B's decode shape under ``2p7b``, with its
launches in phase 34's trace, phase 33's max |out - plain| at each
width under ``widths`` and, for the quantized reads, fp8 under
``fp8``; rows 5 and 10 and the fused decode step carry their launches on
phase 37's path as ``api_launches``, and on phase 38's beam search and
multi-LoRA runs as ``beam_launches`` and ``lora_launches``; rows 17 and
15v and the fused paged step carry phase 38 (c)'s as ``lora_launches``;
rows 5, 13, 15, 17, 15v, the fused paged step and rows 14, 16 and 18
carry phase 39's as ``hostswap_launches``; rows 5, 7, 10, 13, 17, 15v and
both fused decode steps carry phase 40's as ``telemetry_launches``);
the last line is
``{"ok": true, "device": {...}}``. Imports only torch, numpy, the
standard library and ``apex_tpu_torch``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, dense bf16 tensor rate and
#: the fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12

#: the serving path's shapes (bench.py serve(): 355M, 8 slots, horizon
#: 192, prompts <= 64 padded to power-of-two buckets)
HIDDEN, HEADS, HEAD_DIM, SLOTS, HORIZON = 1024, 16, 64, 8, 192

#: the paged and speculative paths (bench.py serve()'s A/Bs): pages of 8
#: tokens over the same horizon, the auto-sized pool (every slot's 24
#: pages plus the sink), and verify writes of spec_k + 1 = 4 columns
PAGE = 8
MAX_PAGES = HORIZON // PAGE
NUM_PAGES = SLOTS * MAX_PAGES + 1
SPEC_K = 3
SPEC_T = SPEC_K + 1

#: the training path's shapes (bench.py main(): batch 16 of seq 1024) and
#: its timed steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 10
#: timing at the training shapes, where one call takes milliseconds
TRAIN_TIMING = dict(reps=5, inner=4)
#: adam_flat kernel vs plain in fp32: the same expression, rounded in
#: another order (fused multiply-adds)
ADAM_TOL = dict(atol=1e-6, rtol=1e-5)
#: flat vs tree layout: the same update, rounded at other places, and
#: bf16 training carries an ulp forward; the per-step losses of the two
#: runs may differ by this much (they fall by about 0.8 over the run). The
#: first step's losses, before any update, must be equal.
LAYOUT_LOSS_BAND = 5e-2

#: the BERT path: batch 32 of seq 512 (16,384 tokens a step, as the GPT
#: step's); the loss must fall by at least this much over its 11 steps on
#: the repeated batch. The example's targets are its unmasked input
#: tokens, so the model learns to copy them through the tied table: the
#: loss falls by about 1.6 on an H100.
BERT_BATCH = 32
BERT_LOSS_FALL = 0.5
#: runs (a) and (b) of the BERT step differ in the blocks' LayerNorm
#: (kernel vs PyTorch, both fp32 statistics rounded to bf16 at the same
#: place) and the optimizer layout (the same update, rounded at other
#: places): their losses may differ by this much at any step (the GPT
#: step's two layouts differ by up to 6.2e-3 on an H100)
BERT_LOSS_BAND = 2e-2

#: tolerances of kernel vs plain, both on the card in the working type.
#: bf16 outputs: the kernel and the plain version both accumulate in
#: fp32 but in another order, and the result is rounded to bf16 (8 bits
#: of mantissa: one ulp is 2^-7 relative), so allow ~2.5 ulp.
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
#: fp32 statistics (lse) and fp32 runs differ only by summation order
FP32_TOL = dict(atol=1e-3, rtol=1e-3)

#: the two flash forwards' bf16 kernel, and what runs the other dtypes
TC_VARIANT = {
    "flash_attention_bsh": "tensor cores (csrc/flash_fwd_tc.cu, bf16 and "
                           "fp16); fp32 on csrc/flash_attention_bsh.cu",
    "flash_attention": "tensor cores (csrc/flash_fwd_tc.cu, bf16 and fp16, "
                       "d % 8 == 0); the rest on csrc/flash_attention.cu"}
#: the tensor-core forward's bf16 out against its plain twin. Both round
#: P to bf16 before P V and sum in fp32, so the rtol is one bf16 ulp
#: (2^-7 relative); the kernel rounds exp(s - m) at its running max where
#: the twin takes the row's final max, which the atol covers. The CUDA-core
#: kernel, which keeps P in fp32, exceeds it (phase 25 logs by how much).
TC_TOL = dict(atol=2e-3, rtol=2.0 ** -7)
#: the fused backwards' bf16 kernel, and what runs the other dtypes
TC_BWD_VARIANT = {
    "flash_attention_bsh_bwd": "tensor cores (csrc/flash_bwd_tc.cu, bf16 "
                               "and fp16); fp32 on "
                               "csrc/flash_attention_bsh_bwd.cu",
    "flash_attention_bwd": "tensor cores (csrc/flash_bwd_tc.cu, bf16 and "
                           "fp16, d % 8 == 0); the rest on "
                           "csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dq": "tensor cores (csrc/flash_bwd_dq_tc.cu, bf16 "
                              "and fp16, d % 8 == 0); the rest on "
                              "csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkdv": "tensor cores (csrc/flash_bwd_tc.cu without "
                                "its dQ share, bf16 and fp16, d % 8 == 0); "
                                "the rest on csrc/flash_attention_bwd.cu"}
#: the tensor-core backward's bf16 gradients against their plain twins.
#: Both round P and dS to bf16 before the dV, dK and dQ products and sum in
#: fp32, in another order (dQ by atomics, in no fixed order); a P or dS
#: within an fp32 rounding of a bf16 boundary lands on either side, and
#: bf16 gradients round once more (one ulp: the rtol). Each gradient
#: within ``atol_rel`` of its largest entry plus the rtol, elementwise,
#: and the RMS of the difference within ``rms`` of the twin's RMS. Such
#: flips are rare, so the RMS stays at 1.4e-4 or less on every shape of
#: phases 7, 11 and 25; the CUDA-core bf16 kernels, which keep P and dS in
#: fp32, are 1.7e-3 to 2.9e-3 off everywhere, and need atol_rel 1.0e-3 to
#: 1.6e-3 at the step shapes (6.0e-4 and less for the tensor-core kernel;
#: NVIDIA H100 80GB HBM3, 700.00 W). The phases log both and check that
#: the CUDA-core kernel misses the RMS bound.
BWD_TC_TOL = dict(atol_rel=1e-3, rtol=2.0 ** -7, rms=5e-4)
#: the same for fp16 (the kernels' fp16 instantiation against the twins
#: that round P, and P and dS, to fp16): the rtol is one fp16 ulp (2^-10
#: relative); a P or dS within an fp32 rounding of an fp16 boundary lands
#: on either side, as in bf16, but fp16's boundaries are 8x finer and so
#: each flip 8x smaller. No looser than TC_TOL / BWD_TC_TOL. Measured on
#: an NVIDIA H100 80GB HBM3 (700.00 W) at phases 21 and 25's shapes: the
#: forward needs atol 1.2e-4 at most, the backward atol_rel 9.1e-5 and
#: an RMS of 4.9e-5; the fp32 CUDA-core kernels on the widened inputs (P
#: and dS unrounded) need as little atol (8.2e-5: fp16's rounding of P
#: is below the output's own) but miss the RMS bound (3.3e-4).
F16_TC_TOL = dict(atol=5e-4, rtol=2.0 ** -10)
F16_BWD_TC_TOL = dict(atol_rel=5e-4, rtol=2.0 ** -10, rms=1e-4)


def grad_tol(ref: torch.Tensor) -> dict:
    """bf16 gradients at the train shape: entries there are about 0.05,
    so a fixed atol of 2e-2 would pass a kernel that dropped a key tile.
    The limit is 1e-2 of the reference's RMS plus BF16_TOL's rtol."""
    rms = float(ref.float().pow(2).mean().sqrt())
    return dict(atol=1e-2 * rms, rtol=BF16_TOL["rtol"])


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(*a) -> None:
    print(*a, flush=True)


def check_tc(what: str, counts, name: str, want=None) -> None:
    """Every launch of the flash forward or fused backward ``name`` in
    ``counts`` (bf16 on the main paths) went to its tensor-core kernel
    (``<name>_tc``), or exactly ``want`` of them did."""
    n = counts[name] if want is None else want
    check(counts[f"{name}_tc"] == n,
          f"{what}: {counts[f'{name}_tc']} of {counts[name]} {name} "
          f"launches on the tensor-core kernel, expected {n}")


def time_ms(fn, *, reps: int = 15, inner: int = 20) -> float:
    """The card's time per call: ``inner`` calls captured in one CUDA
    graph, replayed between CUDA events ``reps`` times (median), after a
    warm-up. The graph takes the host's launch cost out of the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / inner)
    return statistics.median(per)


def eager_ms(fn, *, reps: int = 15, inner: int = 20) -> float:
    """Per call with ``inner`` eager calls back to back between CUDA
    events (median over ``reps``): what a caller that launches from
    Python sees, the wrapper's host cost included when it is the larger
    one."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / inner)
    return statistics.median(per)


def bound(n_bytes: float, n_flops: float,
          flops_per_s: float = BF16_FLOPS_PER_S):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_f = n_flops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def write_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over two written caches, a cell that is NaN in both
    counting as equal (phase 15 fills the unwritten cells with NaN)."""
    d = (a.float() - b.float()).abs()
    return float(d.masked_fill(a.isnan() & b.isnan(), 0).max())


def close(a, b, tol) -> bool:
    return bool(torch.allclose(a.float(), b.float(), **tol))


def atol_needed(a, b, rtol: float) -> float:
    """The least atol with which ``close(a, b, dict(atol=..., rtol=rtol))``
    holds."""
    d = (a.float() - b.float()).abs() - rtol * b.float().abs()
    return max(float(d.max()), 0.0)


#: one ulp of each output dtype, relative
ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


def bwd_tc_errs(got, want, tol=BWD_TC_TOL):
    """``(atol_rel, rms)`` of one gradient against its twin: the least atol,
    as a share of ``want``'s largest entry, with which it is within
    ``tol``'s rtol elementwise, and the RMS of the difference over
    ``want``'s RMS."""
    w = want.float()
    d = got.float() - w
    top = max(float(w.abs().max()), 1e-30)
    rms = float(d.pow(2).mean().sqrt()) / max(float(w.pow(2).mean().sqrt()),
                                              1e-30)
    return atol_needed(got, want, tol["rtol"]) / top, rms


def hold_bwd_tc(what: str, got, want, seen: dict, side: str = "tc",
                tol=BWD_TC_TOL):
    """Hold the three gradients of a tensor-core backward (``side="tc"``)
    to ``tol`` (BWD_TC_TOL, or F16_BWD_TC_TOL for fp16), or only measure a
    CUDA-core kernel's (``"cuda_core"``); the worst ``atol_rel`` and
    ``rms`` go into ``seen[side]``."""
    worst = seen.setdefault(side, {"atol_rel": 0.0, "rms": 0.0})
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(a).all()), f"{what}: non-finite {name}")
        atol_rel, rms = bwd_tc_errs(a, w, tol)
        worst["atol_rel"] = max(worst["atol_rel"], atol_rel)
        worst["rms"] = max(worst["rms"], rms)
        if side == "tc":
            check(atol_rel <= tol["atol_rel"] and rms <= tol["rms"],
                  f"{what}: {name} needs atol {atol_rel:.3e} x max, rms "
                  f"{rms:.3e} (tolerance {tol})")


def check_cc_fails(what: str, got, want, tol=BWD_TC_TOL) -> None:
    """The CUDA-core backward (P and dS in fp32) on the same inputs must
    miss ``tol``'s RMS bound, else the bound tells the kernels apart by
    nothing."""
    rms = max(bwd_tc_errs(a, w, tol)[1] for a, w in zip(got, want))
    check(rms > tol["rms"], f"{what}: the CUDA-core kernel is within "
          f"the tolerance's rms {tol['rms']} ({rms:.3e})")


def bsh_bwd_cuda_core(q, k, v, do, lse, delta, heads: int, causal: bool):
    """``csrc/flash_attention_bsh_bwd.cu``'s bf16 kernel (P and dS in fp32)
    on the lane-packed op's inputs, launched directly (the op sends bf16 to
    the tensor cores): ``(launch, (dq, dk, dv))``."""
    from apex_tpu_torch.kernels import _build

    b, s, hidden = q.shape
    out = [torch.empty_like(t) for t in (q, k, v)]

    def launch():
        _build.check(_build.library().apex_tpu_torch_flash_bwd_bsh(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(t.data_ptr() for t in out),
            b, s, k.shape[1], hidden, heads, (hidden // heads) ** -0.5,
            int(causal), _build.DTYPE_CODES[q.dtype], _build.stream()),
            "flash_attention_bsh_bwd (CUDA cores)")
    launch()
    return launch, out


def hm_bwd_cuda_core(q, k, v, do, lse, delta, *, causal, n_rep, lens=None,
                     segs=None, entry="fused"):
    """``csrc/flash_attention_bwd.cu``'s bf16 kernel (P and dS in fp32) on
    the head-major op's inputs, launched directly: the fused sweep, or with
    ``entry`` "dq" or "dkdv" a split one. ``(launch, (dq, dk, dv))`` in
    fp32, of which a split sweep writes its own."""
    from apex_tpu_torch.kernels import _build

    bh, sq, d = q.shape
    out = [torch.empty(t.shape, dtype=torch.float32, device=t.device)
           for t in (q, k, v)]
    seg_q, seg_k = segs if segs is not None else (None, None)
    ptr = lambda t: None if t is None else t.data_ptr()

    def launch():
        fn = getattr(_build.library(), f"apex_tpu_torch_flash_bwd_hm_{entry}")
        _build.check(fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), ptr(lens), ptr(seg_q),
            ptr(seg_k), *(t.data_ptr() for t in out), bh, n_rep, sq,
            k.shape[1], d, d ** -0.5, int(causal),
            _build.DTYPE_CODES[q.dtype], _build.stream()),
            f"flash_attention_bwd {entry} (CUDA cores)")
    launch()
    return launch, out


def ulp_close(got, want) -> bool:
    """Within one ulp of ``want``'s dtype, plus 1e-6 of its largest entry:
    both sides compute in fp32 (sums in another order) and round once.
    Among subnormals one ulp is the fixed subnormal step (2^-24 in fp16),
    not a share of the value."""
    want32 = want.float()
    fi = torch.finfo(want.dtype)
    ulp = torch.clamp(ULP[want.dtype] * want32.abs(),
                      min=fi.smallest_normal * fi.eps)
    lim = ulp + 1e-6 * float(want32.abs().max())
    return bool(((got.float() - want32).abs() <= lim).all())


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke runs on the card")
    name = torch.cuda.get_device_name(0)
    cap = tuple(torch.cuda.get_device_capability(0))
    log(f"device: {name} count={torch.cuda.device_count()} "
        f"capability={cap} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"card: {card}")
    check(cap == (9, 0), f"compute capability {cap} != (9, 0)")
    return name, card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from apex_tpu_torch.kernels import _build

    info = _build.build()
    _build.library()
    log(f"build: {info.path} in {info.seconds:.1f}s")
    for line in info.ptxas_log.read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")
    return info


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain
# ---------------------------------------------------------------------------

def phase_kernels():
    from apex_tpu_torch.kernels import (
        attend_cache,
        attend_cache_plain,
        flash_attention_bsh_fwd,
        flash_attention_bsh_plain,
        launch_counts,
        reset_launch_counts,
        write_column,
        write_column_plain,
    )
    from apex_tpu_torch.kernels.decode_attention import check_positions

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = {}

    # -- flash prefill: b in {1, 4}, s in {8, 64} (and a ragged 24), causal;
    #    bf16 on the tensor-core kernel, fp32 on the CUDA-core one
    worst_out = worst_lse = 0.0
    reset_launch_counts()
    for seed in (0, 1):
        for b, s in ((1, 8), (1, 64), (4, 8), (4, 64), (2, 24)):
            g = torch.Generator(device=dev).manual_seed(seed * 100 + b * s)
            q, k, v = (torch.randn(b, s, HIDDEN, generator=g, device=dev,
                                   dtype=bf16) for _ in range(3))
            out, lse = flash_attention_bsh_fwd(q, k, v, num_heads=HEADS,
                                               causal=True)
            ref, ref_lse = flash_attention_bsh_plain(
                q, k, v, num_heads=HEADS, causal=True)
            torch.cuda.synchronize()
            check(close(out, ref, TC_TOL),
                  f"flash b={b} s={s}: out err {max_err(out, ref)}")
            check(close(lse, ref_lse, FP32_TOL),
                  f"flash b={b} s={s}: lse err {max_err(lse, ref_lse)}")
            worst_out = max(worst_out, max_err(out, ref))
            worst_lse = max(worst_lse, max_err(lse, ref_lse))
    check_tc("phase 3 bf16 flash", launch_counts(), "flash_attention_bsh")
    q32, k32, v32 = (t.float() for t in (q, k, v))
    o32, l32 = flash_attention_bsh_fwd(q32, k32, v32, num_heads=HEADS,
                                       causal=True)
    r32, rl32 = flash_attention_bsh_plain(q32, k32, v32, num_heads=HEADS,
                                          causal=True)
    check(close(o32, r32, FP32_TOL) and close(l32, rl32, FP32_TOL),
          f"flash fp32 err {max_err(o32, r32)} / {max_err(l32, rl32)}")
    check_tc("phase 3 fp32 flash", launch_counts(), "flash_attention_bsh",
             want=10)
    log(f"flash_attention_bsh: bf16 (tensor cores) max|out-plain|="
        f"{worst_out:.3e} (TC_TOL) max|lse-plain|="
        f"{worst_lse:.3e} (tol 1e-3); fp32 (CUDA cores) max|out-plain|="
        f"{max_err(o32, r32):.3e}")

    # timings at the largest prefill group of the path: b=4, s=64
    b, s = 4, 64
    g = torch.Generator(device=dev).manual_seed(7)
    q, k, v = (torch.randn(b, s, HIDDEN, generator=g, device=dev, dtype=bf16)
               for _ in range(3))
    fa = lambda: flash_attention_bsh_fwd(q, k, v, num_heads=HEADS,
                                         causal=True)
    fp = lambda: flash_attention_bsh_plain(q, k, v, num_heads=HEADS,
                                           causal=True)
    hd = lambda t: t.view(b, s, HEADS, HEAD_DIM).transpose(1, 2)
    fl = lambda: F.scaled_dot_product_attention(hd(q), hd(k), hd(v),
                                                is_causal=True)
    n_bytes = 4 * b * s * HIDDEN * 2 + b * HEADS * s * 4
    n_flops = 4 * HEAD_DIM * b * HEADS * s * (s + 1) / 2
    bms, by = bound(n_bytes, n_flops)
    rows["flash_attention_bsh"] = dict(
        name="flash_attention_bsh", route="cuda",
        source="apex_tpu_torch/csrc/flash_fwd_tc.cu",
        replaces="apex_tpu/kernels/flash_attention.py:1005",
        variant=TC_VARIANT["flash_attention_bsh"],
        max_abs_err=worst_out, ms=time_ms(fa), eager_ms=eager_ms(fa),
        plain_ms=time_ms(fp), bound_ms=bms, bound_by=by,
        library_ms=time_ms(fl),
        shape=f"b={b} s={s} hidden={HIDDEN} heads={HEADS} bf16 causal")

    # -- decode: b 8, h 16, S 192, d 64; columns past pos hold NaN
    B, H, S, D = SLOTS, HEADS, HORIZON, HEAD_DIM
    worst_attn = 0.0
    col = torch.arange(S, device=dev)
    for seed, pos_l in ((0, [0, 191, 5, 63, 64, 100, 127, 190]),
                        (1, [191, 0, 31, 32, 33, 150, 1, 96])):
        g = torch.Generator(device=dev).manual_seed(seed)
        mk = lambda *shp: torch.randn(*shp, generator=g, device=dev,
                                      dtype=bf16)
        qd, kn, vn = mk(B, H, D), mk(B, H, D), mk(B, H, D)
        kc, vc = mk(B, H, S, D), mk(B, H, S, D)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        check_positions(pos, S)
        stale = (col[None] > pos[:, None].long())[:, None, :, None]
        kc = kc.masked_fill(stale, float("nan"))
        vc = vc.masked_fill(stale, float("nan"))
        kc_k, vc_k, kc_p, vc_p = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        write_column(kn, vn, kc_k, vc_k, pos)
        write_column_plain(kn, vn, kc_p, vc_p, pos)
        torch.cuda.synchronize()
        bits = lambda t: t.view(torch.int16)
        check(torch.equal(bits(kc_k), bits(kc_p))
              and torch.equal(bits(vc_k), bits(vc_p)),
              "write_column: caches differ from the plain write (bitwise)")
        out = attend_cache(qd, kc_k, vc_k, pos)
        ref = attend_cache_plain(qd, kc_p, vc_p, pos)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()),
              "attend_cache: non-finite output (stale NaN columns leaked)")
        check(close(out, ref, BF16_TOL),
              f"attend_cache pos={pos_l}: err {max_err(out, ref)}")
        worst_attn = max(worst_attn, max_err(out, ref))
    o32 = attend_cache(qd.float(), kc_k.float(), vc_k.float(), pos)
    r32 = attend_cache_plain(qd.float(), kc_p.float(), vc_p.float(), pos)
    check(close(o32, r32, FP32_TOL), f"attend fp32 err {max_err(o32, r32)}")
    log(f"decode: write_column bit-exact; attend_cache bf16 "
        f"max|out-plain|={worst_attn:.3e} (tol atol=rtol=2e-2), fp32 "
        f"{max_err(o32, r32):.3e}; NaN past pos stayed masked")

    # timings at the path's decode shape with the second seed's positions
    kw, vw = kc_k.clone(), vc_k.clone()
    kvw = torch.stack([kw, vw])
    n_cols = int((pos.long() + 1).sum())
    wb, wby = bound(4 * B * H * D * 2, 0)
    rows["decode_write_column"] = dict(
        name="decode_write_column", route="cuda",
        source="apex_tpu_torch/csrc/decode_attention.cu",
        replaces="apex_tpu/kernels/decode_attention.py:108",
        max_abs_err=0.0,
        ms=time_ms(lambda: write_column(kn, vn, kw, vw, pos)),
        eager_ms=eager_ms(lambda: write_column(kn, vn, kw, vw, pos)),
        plain_ms=time_ms(lambda: write_column_plain(kn, vn, kw, vw, pos)),
        bound_ms=wb, bound_by=wby,
        library_ms=time_ms(lambda: _index_put_planes(
            kvw, torch.arange(B, device=dev), pos.long(),
            torch.stack([kn, vn]))),
        shape=f"b={B} h={H} S={S} d={D} bf16")
    ab, aby = bound(2 * B * H * D * 2 + 2 * n_cols * H * D * 2,
                    4 * n_cols * H * D)
    mask = (col[None] <= pos[:, None].long())[:, None, None, :]
    rows["decode_attention"] = dict(
        name="decode_attention", route="cuda",
        source="apex_tpu_torch/csrc/decode_attention.cu",
        replaces="apex_tpu/kernels/decode_attention.py:339",
        max_abs_err=worst_attn,
        ms=time_ms(lambda: attend_cache(qd, kc_k, vc_k, pos)),
        eager_ms=eager_ms(lambda: attend_cache(qd, kc_k, vc_k, pos)),
        plain_ms=time_ms(lambda: attend_cache_plain(qd, kc_k, vc_k, pos)),
        bound_ms=ab, bound_by=aby,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kc_k, vc_k, attn_mask=mask)),
        shape=f"b={B} h={H} S={S} d={D} bf16 pos={pos.tolist()}")
    # the decode step's write and read in one launch (rows 7 + 10)
    rows["decode_attention_write"] = fused_row(paged=False)
    for r in rows.values():
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (eager, host issue "
            f"included: {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f}"
            f" ms, library {r['library_ms']} ms, bound {r['bound_ms']:.5f} "
            f"ms ({r['bound_by']}) at {r['shape']}")
    reset_launch_counts()
    return rows


# ---------------------------------------------------------------------------
# phase 4: whole model, kernels vs the materialised-scores path
# ---------------------------------------------------------------------------

def model_config():
    """bench.py serve()'s configuration: the training bench's 355M in its
    decode form, bf16."""
    from apex_tpu_torch.models import gpt

    return gpt.GPTConfig(
        vocab_size=50304, hidden_size=1024, num_layers=24, num_heads=16,
        seq_len=1024, remat=False, compute_dtype=torch.bfloat16,
        attn_impl="flash", ln_impl="xla")


def phase_model(cfg, params, fp16: bool = False):
    """Prefill 4 right-padded prompts in one bucket-64 forward, then 8
    decode steps at per-row positions, through three paths on the same
    weights and tokens: the kernels (bf16), the materialised-scores
    "xla" forms (bf16) and the "xla" forms in fp32 (the reference). The
    band: the kernel path's error against fp32 may be at most twice the
    bf16 "xla" path's, and the two bf16 paths may differ by at most three
    times it (the triangle inequality's bound). With ``fp16`` the kernels
    and the "xla" forms run in fp16 too (``compute_dtype=float16``, the
    fp16 decode kernels), held by the same rule against the fp16 "xla"
    path. Returns the bf16 "xla" path's max error, the scale of a bf16
    logit error here."""
    import dataclasses

    from apex_tpu_torch.models import gpt

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    lens = [64, 1, 17, 40]
    prompts = np.zeros((4, 64), np.int64)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, cfg.vocab_size, n)
    steps = rng.integers(0, cfg.vocab_size, (8, 4))
    prompts_t = torch.as_tensor(prompts, device=dev)
    last = torch.as_tensor(lens, device=dev) - 1
    paths = {
        "kernel": dataclasses.replace(cfg, attn_impl="flash",
                                      decode_attn_impl="kernel"),
        "xla": dataclasses.replace(cfg, attn_impl="xla",
                                   decode_attn_impl="xla"),
        "fp32": dataclasses.replace(cfg, attn_impl="xla",
                                    decode_attn_impl="xla",
                                    compute_dtype=torch.float32),
    }
    if fp16:
        for name in ("kernel", "xla"):
            paths[f"{name}_fp16"] = dataclasses.replace(
                paths[name], compute_dtype=torch.float16)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, c in paths.items():
        p = gpt.cast_params(c, params)
        cache, lg = gpt.prefill_many(c, p, prompts_t, last, max_len=80)
        got = [lg.float()]
        pos = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        for j in range(steps.shape[0]):
            lg, cache = gpt.decode_step(
                c, p, cache, torch.as_tensor(steps[j], device=dev), pos + j)
            got.append(lg.float())
        out[name] = torch.stack(got)
        del p, cache
    torch.cuda.synchronize()
    for name, v in out.items():
        check(bool(torch.isfinite(v).all()), f"model {name}: non-finite logits")
    err_k = max_err(out["kernel"], out["fp32"])
    err_x = max_err(out["xla"], out["fp32"])
    diff = max_err(out["kernel"], out["xla"])
    mean = lambda a, b: float((a - b).abs().mean())
    log(f"model: logits [{out['fp32'].shape[0]} steps, 4, "
        f"{cfg.vocab_size}], fp32 std {float(out['fp32'].std()):.3f}; "
        f"max|kernel-fp32|={err_k:.4f} (mean "
        f"{mean(out['kernel'], out['fp32']):.5f}), max|xla-fp32|={err_x:.4f} "
        f"(mean {mean(out['xla'], out['fp32']):.5f}), "
        f"max|kernel-xla|={diff:.4f}")
    check(err_k <= 2 * err_x,
          f"model: kernel path error {err_k} > 2 x xla path error {err_x}")
    check(diff <= 3 * err_x,
          f"model: kernel vs xla {diff} > 3 x xla path error {err_x}")
    if fp16:
        err_k16 = max_err(out["kernel_fp16"], out["fp32"])
        err_x16 = max_err(out["xla_fp16"], out["fp32"])
        diff16 = max_err(out["kernel_fp16"], out["xla_fp16"])
        log(f"model fp16: max|kernel-fp32|={err_k16:.4f}, max|xla-fp32|="
            f"{err_x16:.4f}, max|kernel-xla|={diff16:.4f}")
        check(err_k16 <= 2 * err_x16, f"model fp16: kernel path error "
              f"{err_k16} > 2 x xla path error {err_x16}")
        check(diff16 <= 3 * err_x16, f"model fp16: kernel vs xla {diff16} "
              f"> 3 x xla path error {err_x16}")
    return err_x


# ---------------------------------------------------------------------------
# phase 5: the path — Scheduler over Engine answers bench's trace
# ---------------------------------------------------------------------------

def bench_trace(vocab: int, n: int = 32, max_prompt_len: int = 64,
                max_tokens: int = 64, seed0: int = 1000):
    """bench.py serve()'s request trace, regenerated with numpy: prompt
    length ``1 + (11 i + 5) % 64``, odd requests sampled at temperature
    0.9 with top-k 40 and seed ``i``, even ones greedy, 64 tokens each."""
    from apex_tpu_torch.serving import Request, SamplingParams

    reqs = []
    for i in range(n):
        p_len = 1 + (11 * i + 5) % max_prompt_len
        prompt = np.random.default_rng(seed0 + i).integers(
            0, vocab, p_len).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=40, seed=i) if i % 2
              else SamplingParams())
        reqs.append(Request(f"r{i}", prompt, max_tokens=max_tokens,
                            sampling=sp))
    return reqs


#: every kernel one single-token decode step can launch for a layer's
#: attention: the fused write + read (compute-dtype caches), the
#: stand-alone single-column writes and reads (the counterparts of JAX's
#: functions, which no serving path launches), and the quantized writes
#: and reads
DECODE_STEP_KERNELS = (
    "decode_attention_write", "paged_attention_write",
    "decode_write_column", "decode_attention", "paged_write_column",
    "paged_attention", "decode_write_column_quant", "decode_attention_quant",
    "paged_write_column_quant", "paged_attention_quant")


def check_decode_step_kernels(what: str, counts, on, steps: int, L: int,
                              allow_no_steps: bool = False) -> None:
    """Each kernel of ``on`` launched L x ``steps`` times (and ``steps``
    positive unless ``allow_no_steps``), every other kernel of
    DECODE_STEP_KERNELS none."""
    for name in DECODE_STEP_KERNELS:
        want = L * steps if name in on else 0
        check(counts[name] == want
              and (steps > 0 or allow_no_steps or name not in on),
              f"{what}: {name} launched {counts[name]} times, expected "
              f"{want} ({L} layers x {steps} decode steps)")


def phase_path(cfg, params, band: float):
    """Serve the trace (every request submitted at t=0, then
    ``run_until_idle``) with the launch counts zeroed just before and read
    just after; then hold every stream against a teacher-forced reference
    forward without kernels ("xla" attention): each emitted token's
    logprob within ``band`` of the reference's, and each greedy token's
    reference logit within ``band`` of the row's maximum."""
    import dataclasses

    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import Engine, EngineConfig, Scheduler

    ecfg = EngineConfig(slots=SLOTS, max_prompt_len=64, max_seq_len=HORIZON)
    engine = Engine(cfg, params, ecfg)
    sched = Scheduler(engine)
    reqs = bench_trace(cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    s = sched.summary()
    L = cfg.num_layers
    log(f"path: {len(sched.completions)} requests in {wall:.2f}s, "
        f"{engine.decode_steps_taken} decode steps, {engine.admit_groups} "
        f"admission groups, launches {counts}")
    check(len(sched.completions) == len(reqs), "path: not every request "
          "completed")
    for r in reqs:
        c = sched.completions[r.request_id]
        check(c.finish_reason in ("length", "eos"),
              f"path: {r.request_id} finished {c.finish_reason}")
        check(len(c.tokens) == r.max_tokens or c.finish_reason == "eos",
              f"path: {r.request_id} emitted {len(c.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"path: {r.request_id} emitted a token outside the vocab")
    check_decode_step_kernels("path", counts, ("decode_attention_write",),
                              engine.decode_steps_taken, L)
    check(counts["flash_attention_bsh"] == L * engine.admit_groups > 0,
          f"path: flash_attention_bsh launched "
          f"{counts['flash_attention_bsh']} times, expected {L} x "
          f"{engine.admit_groups} groups")
    check_tc("path", counts, "flash_attention_bsh")
    metrics = {k: s[k] for k in ("tokens_per_sec", "decode_tokens_per_sec",
                                 "ttft_mean_ms", "ttft_p99_ms",
                                 "token_latency_mean_ms", "decode_steps",
                                 "admit_dispatches", "tokens_emitted")}
    metrics["peak_memory_bytes"] = peak
    metrics["wall_s"] = wall
    log("path metrics: " + json.dumps(metrics))

    worst_lp, worst_gap = hold_streams(cfg, params, reqs, sched.completions)
    log(f"path vs reference forward: max|logprob-ref|={worst_lp:.4f}, "
        f"greedy max(ref max logit - chosen)={worst_gap:.4f} (band "
        f"{band:.4f})")
    check(worst_lp <= band, f"path: logprobs off the reference by {worst_lp}")
    check(worst_gap <= band, f"path: a greedy token is {worst_gap} below "
          f"the reference's best")
    streams = {r: c.tokens for r, c in sched.completions.items()}
    return counts, metrics, engine, streams


def hold_streams(cfg, params, reqs, completions):
    """Teacher-force every stream through a full forward without kernels
    ("xla" attention) over prompt + stream: returns the largest
    |logprob - reference logprob| over every emitted token, and over the
    greedy streams the largest gap between the reference's best logit and
    the chosen token's."""
    import dataclasses

    from apex_tpu_torch.models import gpt

    ref_cfg = dataclasses.replace(cfg, attn_impl="xla")
    p = gpt.cast_params(ref_cfg, params)
    worst_lp = worst_gap = 0.0
    for r in reqs:
        c = completions[r.request_id]
        seq = torch.as_tensor([list(r.prompt) + c.tokens[:-1]],
                              device="cuda")
        n0 = len(r.prompt) - 1
        lg = gpt.logits(ref_cfg, p, seq)[0, n0:].float()
        toks = torch.as_tensor(c.tokens, device="cuda")
        ref_lp = torch.log_softmax(lg, -1).gather(1, toks[:, None])[:, 0]
        lp = torch.as_tensor(c.logprobs, device="cuda")
        worst_lp = max(worst_lp, float((lp - ref_lp).abs().max()))
        if r.sampling.temperature == 0.0:
            gap = lg.amax(-1) - lg.gather(1, toks[:, None])[:, 0]
            worst_gap = max(worst_gap, float(gap.max()))
    return worst_lp, worst_gap


# ---------------------------------------------------------------------------
# phase 6: where the time goes (profiled decode window, not counted)
# ---------------------------------------------------------------------------

#: the CUDA API calls that launch a kernel, as the profiler names them
LAUNCH_API = re.compile(r"^cu(da)?LaunchKernel")


def phase_profile(cfg, engine, chunks: int = 16, reqs=None,
                  what: str = "profile", sched_kw=None, chunk=None):
    """A window of ``chunks`` decode chunks over 8 live slots (``reqs``,
    by default 8 requests of bench's trace, 40 tokens each) under
    ``torch.profiler``: the device's busy share and the kernels that
    take its time; per decode step the host's ms (the window's wall
    time, the profiler's cost included) and the kernels launched (CUDA
    API launch calls, and the device's own records); and the decode
    reads' device time and calls beside the fused write + read's launches
    in the window (the launch counts zeroed at its start and read at its
    end): no stand-alone single-column write or read may run, so every
    plain instantiation of the split read the profiler records is one of
    those launches (it must record some where there were some, and no
    more). Where the profiler shows no device time the numbers print as
    "not measured". ``sched_kw`` goes to the window's ``Scheduler``, and
    ``chunk`` (a rung of the engine's ``decode_chunks``) replaces its
    base decode chunk for the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Scheduler

    sched = Scheduler(engine, **(sched_kw or {}))
    if chunk is not None:
        step_async = engine.step_async
        engine.step_async = lambda **kw: step_async(chunk=chunk, **kw)
    for r in reqs or bench_trace(cfg.vocab_size, n=SLOTS, max_tokens=40,
                                 seed0=5000):
        sched.submit(r)
    sched.step()                       # admit all 8, first chunk
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        reset_launch_counts()
        steps0 = engine.decode_steps_taken
        t0 = time.perf_counter()
        for _ in range(chunks):
            sched.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = engine.decode_steps_taken - steps0
        counts = launch_counts()
    sched.run_until_idle()
    if chunk is not None:
        del engine.step_async          # the class's method again
    fused = {k: counts[k] for k in ("decode_attention_write",
                                    "paged_attention_write")}
    alone = {k: counts[k] for k in ("decode_write_column", "decode_attention",
                                    "paged_write_column", "paged_attention")}
    check(not any(alone.values()), f"{what}: a stand-alone single-column "
          f"write or read ran: {alone}")
    api = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CPU and LAUNCH_API.match(e.key))
    # kernels only: an operator's device time is its kernels' again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        log(f"{what}: device time not measured (the profiler saw no "
            "kernel)")
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    # the decode reads' kernels: the split read's plain instantiations
    # (rows 10, 17) apart from its quantized ones (rows 12, 18), and the
    # one-block-a-row quantized kernels they replaced, which must not run
    reads = {kind: [e for e in events if split_read_kind(e.key) == kind]
             for kind in ("plain", "quantized")}
    old = [e for e in events if "attn_quant_kernel" in e.key]
    per_step = max(steps, 1)
    out = {
        "window_steps": chunks * (chunk or engine.engine_cfg.decode_chunk),
        "decode_steps": steps,
        "wall_ms": wall * 1e3,
        "host_ms_per_decode_step": wall * 1e3 / per_step,
        "launches_per_decode_step": api / per_step,
        "device_ops_per_decode_step": sum(e.count for e in events) / per_step,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e3 / (wall * 1e3)),
        "fused_write_read_launches": fused,
        "decode_reads": {
            "ms": sum(e.self_device_time_total for r in reads.values()
                      for e in r) / 1e3,
            "calls": sum(e.count for r in reads.values() for e in r),
            **{kind: {"ms": sum(e.self_device_time_total for e in r) / 1e3,
                      "calls": sum(e.count for e in r)}
               for kind, r in reads.items()}},
        "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top],
    }
    log(f"{what}: " + json.dumps(out))
    check(not old, f"{what}: the replaced quantized read kernels ran: "
          f"{[e.key[:80] for e in old]}")
    # no stand-alone read launched (checked above), so every plain split
    # read on the device is a counted fused launch; the profiler may drop
    # a record (on an H100 it once kept 511 of 512), never add one
    plain = out["decode_reads"]["plain"]["calls"]
    check(plain <= sum(fused.values())
          and (plain > 0) == (sum(fused.values()) > 0),
          f"{what}: {plain} plain split reads on the device, {fused} "
          f"fused launches counted")
    return out


def split_read_kind(key: str):
    """"quantized" for a profiler key of ``decode_read_split_kernel``'s
    int8 or fp8 instantiations (rows 12 and 18: ``<T, signed char, ...>``
    or ``<T, __nv_fp8_e4m3, ...>``), "plain" for its others (rows 10 and
    17: ``<T, T, ...>``), None for any other kernel."""
    if "decode_read_split_kernel" not in key:
        return None
    return ("quantized" if "signed char" in key or "__nv_fp8_e4m3" in key
            else "plain")


# ---------------------------------------------------------------------------
# phase 15: the paged and speculative kernels vs plain, at the path's shapes
# ---------------------------------------------------------------------------

def _index_put_planes(kv, i0, i2, vals):
    """One ``index_put_`` on a layer's ``[2, n, h, cols, d]`` cache writing
    ``vals [2, *idx, h, d]`` at cells ``(i0, i2)`` of both planes — the
    library yardstick of the column writes."""
    plane = torch.arange(2, device=kv.device).view(
        2, *([1] * i0.ndim), 1)
    hh = torch.arange(kv.shape[2], device=kv.device)
    kv.index_put_((plane, i0[None, ..., None], hh, i2[None, ..., None]),
                  vals)


def phase_paged_kernels():
    """The four kernels of the paged and speculative paths against their
    plain versions at the serving path's shapes: 8 rows of 16 heads of 64
    in bf16, pages of 8 over a 192-column horizon (24 pages a row, 193 in
    the pool with the sink), speculative writes of 4 columns. Every
    table is a random permutation of pages 1..192; every pool cell past a
    row's position, and the whole sink page, holds NaN. The writes must be
    bit-equal to their plain versions (lanes past the horizon included),
    the paged read within BF16_TOL of its plain version and bit-equal to
    the contiguous kernel on the gathered cache. Then the paged fused
    write + read (:func:`fused_row`), held and timed as phase 3 holds
    and times the contiguous one."""
    from apex_tpu_torch.kernels import (
        attend_cache,
        cache_write_columns,
        cache_write_columns_plain,
        paged_attention,
        paged_attention_plain,
        paged_write_column,
        paged_write_column_plain,
        paged_write_columns,
        paged_write_columns_plain,
        reset_launch_counts,
    )
    from apex_tpu_torch.kernels.decode_attention import (
        check_positions,
        paged_gather_xla,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    B, H, D, P, MP, T = SLOTS, HEADS, HEAD_DIM, PAGE, MAX_PAGES, SPEC_T
    N, S = NUM_PAGES, MAX_PAGES * PAGE
    nan = float("nan")
    col = torch.arange(S, device=dev)
    bits = lambda t: t.view(torch.int16)
    same = lambda a, b: torch.equal(bits(a), bits(b))
    worst = worst32 = 0.0
    werr = dict.fromkeys(("paged_write_column", "paged_write_columns",
                          "cache_write_columns"), 0.0)
    for seed, pos_l in ((0, [0, 7, 8, 191, 63, 100, 189, 150]),
                        (1, [191, 0, 8, 7, 190, 31, 64, 188])):
        g = torch.Generator(device=dev).manual_seed(100 + seed)
        mk = lambda *shp: torch.randn(*shp, generator=g, device=dev,
                                      dtype=bf16)
        table = (torch.randperm(N - 1, generator=g, device=dev) + 1).to(
            torch.int32).view(B, MP)
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        check_positions(pos, S)
        stale = (col[None] > pos[:, None].long())[:, None, :, None]
        q, kn, vn = mk(B, H, D), mk(B, H, D), mk(B, H, D)
        kc = mk(B, H, S, D).masked_fill(stale, nan)
        vc = mk(B, H, S, D).masked_fill(stale, nan)
        kp = torch.full((N, H, P, D), nan, device=dev, dtype=bf16)
        vp = torch.full((N, H, P, D), nan, device=dev, dtype=bf16)
        for c, pool in ((kc, kp), (vc, vp)):
            pool[table.long()] = c.view(B, H, MP, P, D).permute(0, 2, 1, 3, 4)
        # one column
        kp_k, vp_k, kp_p, vp_p = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        paged_write_column(kn, vn, kp_k, vp_k, table, pos)
        paged_write_column_plain(kn, vn, kp_p, vp_p, table, pos)
        torch.cuda.synchronize()
        check(same(kp_k, kp_p) and same(vp_k, vp_p),
              "paged_write_column: pools differ from the plain write "
              "(bitwise)")
        werr["paged_write_column"] = max(
            werr["paged_write_column"], write_err(kp_k, kp_p),
            write_err(vp_k, vp_p))
        # the read, after the write, as on the path
        out = paged_attention(q, kp_k, vp_k, table, pos)
        ref = paged_attention_plain(q, kp_p, vp_p, table, pos)
        contig = attend_cache(q, paged_gather_xla(kp_k, table),
                              paged_gather_xla(vp_k, table), pos)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()),
              "paged_attention: non-finite output (NaN cells leaked)")
        check(close(out, ref, BF16_TOL),
              f"paged_attention pos={pos_l}: err {max_err(out, ref)}")
        check(same(out, contig), "paged_attention: not bit-equal to the "
              "contiguous kernel on the gathered cache")
        worst = max(worst, max_err(out, ref))
        o32 = paged_attention(q.float(), kp_k.float(), vp_k.float(), table,
                              pos)
        r32 = paged_attention_plain(q.float(), kp_p.float(), vp_p.float(),
                                    table, pos)
        check(close(o32, r32, FP32_TOL),
              f"paged_attention fp32 err {max_err(o32, r32)}")
        worst32 = max(worst32, max_err(o32, r32))
        # T columns, paged and contiguous (lanes past 191 clamp)
        knt, vnt = mk(B, H, T, D), mk(B, H, T, D)
        kp_k, vp_k, kp_p, vp_p = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        paged_write_columns(knt, vnt, kp_k, vp_k, table, pos)
        paged_write_columns_plain(knt, vnt, kp_p, vp_p, table, pos)
        kc_k, vc_k, kc_p, vc_p = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        cache_write_columns(knt, vnt, kc_k, vc_k, pos)
        cache_write_columns_plain(knt, vnt, kc_p, vc_p, pos)
        torch.cuda.synchronize()
        check(same(kp_k, kp_p) and same(vp_k, vp_p),
              "paged_write_columns: pools differ from the plain write")
        check(same(kc_k, kc_p) and same(vc_k, vc_p),
              "cache_write_columns: caches differ from the plain write")
        werr["paged_write_columns"] = max(
            werr["paged_write_columns"], write_err(kp_k, kp_p),
            write_err(vp_k, vp_p))
        werr["cache_write_columns"] = max(
            werr["cache_write_columns"], write_err(kc_k, kc_p),
            write_err(vc_k, vc_p))
    log(f"paged/spec kernels: three writes bit-exact (lanes past the "
        f"horizon included); paged_attention bf16 max|out-plain|="
        f"{worst:.3e} (tol atol=rtol=2e-2), fp32 {worst32:.3e}, bit-equal "
        f"to decode_attention on the gathered cache; NaN past pos and in "
        f"the sink stayed masked")

    # timings with the second seed's tensors
    rows = {}
    pl = pos.long()
    n_cols = int((pl + 1).sum())
    n_tbl = int(((pl + P) // P).sum())       # table entries the read needs
    shape = f"b={B} h={H} P={P} pages={N} max_pages={MP} d={D} bf16"
    kw, vw = kp.clone(), vp.clone()
    kv = torch.stack([kp, vp])
    pg, off = table.long().gather(1, (pl // P)[:, None])[:, 0], pl % P
    rows["paged_write_column"] = dict(
        name="paged_write_column", route="cuda",
        source="apex_tpu_torch/csrc/decode_attention.cu",
        replaces="apex_tpu/kernels/decode_attention.py:707",
        max_abs_err=werr["paged_write_column"],
        ms=time_ms(lambda: paged_write_column(kn, vn, kw, vw, table, pos)),
        eager_ms=eager_ms(
            lambda: paged_write_column(kn, vn, kw, vw, table, pos)),
        plain_ms=time_ms(
            lambda: paged_write_column_plain(kn, vn, kw, vw, table, pos)),
        library_ms=time_ms(lambda: _index_put_planes(
            kv, pg, off, torch.stack([kn, vn]))),
        shape=shape)
    rows["paged_write_column"].update(zip(
        ("bound_ms", "bound_by"), bound(4 * B * H * D * 2 + B * 8, 0)))
    rows["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="apex_tpu_torch/csrc/decode_attention.cu",
        replaces="apex_tpu/kernels/decode_attention.py:975",
        max_abs_err=worst,
        ms=time_ms(lambda: paged_attention(q, kp_k, vp_k, table, pos)),
        eager_ms=eager_ms(lambda: paged_attention(q, kp_k, vp_k, table, pos)),
        plain_ms=time_ms(
            lambda: paged_attention_plain(q, kp_k, vp_k, table, pos)),
        library_ms=None, shape=shape + f" pos={pos_l}")
    rows["paged_attention"].update(zip(("bound_ms", "bound_by"), bound(
        2 * B * H * D * 2 + 2 * n_cols * H * D * 2 + 4 * (B + n_tbl),
        4 * n_cols * H * D)))
    cols_t = (pl[:, None] + torch.arange(T, device=dev)[None]).clamp(
        max=S - 1)
    pg_t = table.long().gather(1, cols_t // P)
    kvc = torch.stack([kc, vc])
    # the cells the writes must move: each distinct (row, column) that a
    # lane lands on after the clamp (lanes clamped onto a column a later
    # lane of the row writes move nothing), read from new and written to
    # both planes; the paged write also reads one table entry per page
    # those cells touch. Columns and pages rise along a row.
    distinct = lambda c: B + int((c[:, 1:] != c[:, :-1]).sum())
    wbytes = 2 * 2 * distinct(cols_t) * H * D * 2 + B * 4
    tbytes = 4 * distinct(cols_t // P)
    for name, src_line, fn, plain, lib, extra in (
            ("cache_write_columns", 169,
             lambda: cache_write_columns(knt, vnt, kc_k, vc_k, pos),
             lambda: cache_write_columns_plain(knt, vnt, kc_k, vc_k, pos),
             lambda: _index_put_planes(
                 kvc, torch.arange(B, device=dev)[:, None].expand(B, T),
                 cols_t, torch.stack([knt, vnt]).transpose(2, 3)), 0),
            ("paged_write_columns", 811,
             lambda: paged_write_columns(knt, vnt, kp_k, vp_k, table, pos),
             lambda: paged_write_columns_plain(knt, vnt, kp_k, vp_k, table,
                                               pos),
             lambda: _index_put_planes(
                 kv, pg_t, cols_t % P,
                 torch.stack([knt, vnt]).transpose(2, 3)), tbytes)):
        rows[name] = dict(
            name=name, route="cuda",
            source="apex_tpu_torch/csrc/decode_attention.cu",
            replaces=f"apex_tpu/kernels/decode_attention.py:{src_line}",
            max_abs_err=werr[name], ms=time_ms(fn), eager_ms=eager_ms(fn),
            plain_ms=time_ms(plain), library_ms=time_ms(lib),
            shape=(f"b={B} h={H} T={T} S={S} d={D} bf16"
                   if name == "cache_write_columns" else
                   shape + f" T={T}") + f" pos={pos_l}")
        rows[name].update(zip(("bound_ms", "bound_by"),
                              bound(wbytes + extra, 0)))
    # the paged decode step's write and read in one launch (rows 13 + 17)
    rows["paged_attention_write"] = fused_row(paged=True)
    # the verify's write and read in one launch (rows 8 and 15)
    rows.update(verify_rows())
    for r in rows.values():
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (eager, host issue "
            f"included: {r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f}"
            f" ms, library {r['library_ms']} ms, bound {r['bound_ms']:.5f} "
            f"ms ({r['bound_by']}) at {r['shape']}")
    reset_launch_counts()
    return rows


# ---------------------------------------------------------------------------
# phase 16: paged serving — bench's trace, then its mixed trace under a small
# pool
# ---------------------------------------------------------------------------

def mixed_trace(vocab: int, n: int = 32, max_prompt_len: int = 64):
    """bench.py serve()'s paged-A/B trace: odd requests short (length
    ``1 + (5 i + 1) % 6``) and sampled (temperature 0.9, top-k 40, seed
    ``i``), even ones long (``32 + 7 i % 32 + 1``) and greedy, budgets
    ``1 + i % 6``; prompts from numpy seed ``500 + i``."""
    from apex_tpu_torch.serving import Request, SamplingParams

    half = max_prompt_len // 2
    reqs = []
    for i in range(n):
        p_len = 1 + (5 * i + 1) % 6 if i % 2 else half + (7 * i) % half + 1
        prompt = np.random.default_rng(500 + i).integers(
            0, vocab, p_len).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=40, seed=i) if i % 2
              else SamplingParams())
        reqs.append(Request(f"m{i}", prompt, max_tokens=1 + i % 6,
                            sampling=sp))
    return reqs


def run_tracked(engine, reqs):
    """Serve ``reqs`` (all at t=0) and probe the cache at every decode
    dispatch, while the chunk's requests hold their slots, as bench.py's
    paged A/B does: returns the scheduler, the wall time, the cache
    bytes pinned per active token (time-summed pinned bytes over
    time-summed prompt + budget tokens of the active requests: a whole
    stripe per busy slot when contiguous, only the pages in use when
    paged) and the peak of ``pages_in_use``."""
    from apex_tpu_torch.serving import Scheduler

    sched = Scheduler(engine)
    for r in reqs:
        sched.submit(r)
    per_page = (engine.cache_bytes() / engine.describe()["num_pages"]
                if engine.paged else 0.0)
    stripe = engine.cache_bytes() / engine.slots
    acc = dict(pinned=0.0, tokens=0.0, peak=0)
    dispatch = engine.step_async

    def probed(**kw):
        act = sum(len(a.request.prompt) + a.request.max_tokens
                  for a in sched.active.values())
        if engine.paged:
            in_use = engine.page_allocator.pages_in_use
            acc["peak"] = max(acc["peak"], in_use)
            acc["pinned"] += in_use * per_page
        else:
            acc["pinned"] += len(sched.active) * stripe
        acc["tokens"] += act
        return dispatch(**kw)

    engine.step_async = probed
    t0 = time.perf_counter()
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del engine.step_async
    return (sched, wall, acc["pinned"] / max(acc["tokens"], 1.0),
            acc["peak"])


def serve_timed(cfg, params, ecfg, reqs):
    """A fresh ``Engine`` under a ``Scheduler`` serves ``reqs`` (all at
    t=0), with the launch counts zeroed just before and read just after:
    returns the engine, the scheduler, the wall time and the counts."""
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Engine, Scheduler

    engine = Engine(cfg, params, ecfg)
    sched = Scheduler(engine)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    torch.cuda.synchronize()
    return engine, sched, time.perf_counter() - t0, launch_counts()


def phase_paged_path(cfg, params, band: float, contig_streams):
    """(a) bench's 32-request trace through a paged engine with the pool
    auto-sized: its greedy and sampled streams must equal phase 5's
    contiguous ones token for token, and per decode step every layer runs
    the paged write and read and no contiguous decode kernel. The trace
    runs contiguous, paged, paged, contiguous, for the two sides' decode
    tokens/s in one call. (b) bench's mixed trace at ``decode_chunk=8``
    with a 25-page pool, against the contiguous engine: the pool must
    hold admissions back, every request completes, every stream holds the
    reference band, and the pool's peak, the waits for pages and the
    cache bytes pinned per active token are logged."""
    import dataclasses

    from apex_tpu_torch.serving import Engine, EngineConfig

    L = cfg.num_layers
    contig_cfg = EngineConfig(slots=SLOTS, max_prompt_len=64,
                              max_seq_len=HORIZON)
    paged_cfg = dataclasses.replace(contig_cfg, page_size=PAGE)
    tps = {"contig": [], "paged": []}
    for side in ("contig", "paged", "paged", "contig"):
        checked = side == "paged" and not tps["paged"]
        engine, sched, wall, run_counts = serve_timed(
            cfg, params, paged_cfg if side == "paged" else contig_cfg,
            bench_trace(cfg.vocab_size))
        s = sched.summary()
        tps[side].append(s["decode_tokens_per_sec"])
        if not checked:
            del engine, sched
            continue
        counts, steps = run_counts, engine.decode_steps_taken
        check(engine.describe()["num_pages"] == NUM_PAGES,
              f"paged: pool of {engine.describe()['num_pages']} pages")
        log(f"paged path: {len(sched.completions)} requests in "
            f"{wall:.2f}s, {steps} decode steps, {engine.admit_groups} "
            f"admission groups, launches {counts}; decode_tokens_per_sec "
            f"{s['decode_tokens_per_sec']:.1f}, tokens_per_sec "
            f"{s['tokens_per_sec']:.1f}")
        drift = [r for r in contig_streams
                 if sched.completions[r].tokens != contig_streams[r]]
        check(not drift, f"paged path: streams differ from the contiguous "
              f"engine's for {drift}")
        check_decode_step_kernels("paged path", counts,
                                  ("paged_attention_write",), steps, L)
        check(counts["flash_attention_bsh"] == L * engine.admit_groups,
              "paged path: flash prefill launches off the admission groups")
        check_tc("paged path", counts, "flash_attention_bsh")
        log("paged path: all 32 streams (greedy and sampled) identical to "
            "the contiguous engine's")
        del engine, sched
    log("paged vs contiguous, decode tokens/s in the order contiguous, "
        "paged, paged, contiguous: " + json.dumps(tps) + f"; paged / "
        f"contiguous {sum(tps['paged']) / sum(tps['contig']):.3f}")

    # (b) the mixed trace under a 25-page pool, against contiguous
    base = dict(slots=SLOTS, max_prompt_len=64, max_seq_len=HORIZON,
                decode_chunk=8)
    reqs = mixed_trace(cfg.vocab_size)
    out = {}
    for name, ecfg in (("paged", EngineConfig(**base, page_size=PAGE,
                                              num_pages=25)),
                       ("contig", EngineConfig(**base))):
        engine = Engine(cfg, params, ecfg)
        sched, wall, per_tok, peak = run_tracked(engine, reqs)
        check(len(sched.completions) == len(reqs)
              and all(len(sched.completions[r.request_id].tokens)
                      == r.max_tokens for r in reqs),
              f"mixed {name}: not every request completed in full")
        worst_lp, worst_gap = hold_streams(cfg, params, reqs,
                                           sched.completions)
        check(worst_lp <= band and worst_gap <= band,
              f"mixed {name}: streams off the reference by {worst_lp} / "
              f"{worst_gap} (band {band})")
        s = sched.summary()
        out[name] = dict(wall_s=wall, bytes_per_active_token=per_tok,
                         pages_in_use_peak=peak,
                         pages_exhausted_waits=s.get(
                             "pages_exhausted_waits", 0.0),
                         page_deferrals=s.get("page_deferrals", 0.0),
                         decode_tokens_per_sec=s["decode_tokens_per_sec"],
                         max_logprob_err=worst_lp, greedy_gap=worst_gap)
        del engine, sched
    check(out["paged"]["page_deferrals"] > 0,
          "mixed paged: the 25-page pool never held an admission back")
    out["capacity_gain"] = (out["contig"]["bytes_per_active_token"]
                            / out["paged"]["bytes_per_active_token"])
    log("mixed trace: " + json.dumps(out))
    out["trace_decode_tokens_per_sec"] = tps
    return counts, out


# ---------------------------------------------------------------------------
# phase 17: speculative serving; phase 18: paged + speculative
# ---------------------------------------------------------------------------

def spec_trace(vocab: int, adversarial: bool, n: int = 16,
               max_prompt_len: int = 16, max_tokens: int = 96):
    """bench.py serve()'s speculative A/B trace at its on-chip size: 16
    requests of 96 tokens, prompt length ``1 + (11 i + 5) % 16`` from
    numpy seed ``700 + i``; "high" is greedy, "adv" samples at
    temperature 1.5 with seed ``i``."""
    from apex_tpu_torch.serving import Request, SamplingParams

    reqs = []
    for i in range(n):
        p_len = 1 + (11 * i + 5) % max_prompt_len
        prompt = np.random.default_rng(700 + i).integers(
            0, vocab, p_len).tolist()
        sp = (SamplingParams(temperature=1.5, seed=i) if adversarial
              else SamplingParams())
        reqs.append(Request(f"s{i}", prompt, max_tokens=max_tokens,
                            sampling=sp))
    return reqs


def spec_config(**over):
    """bench.py serve()'s speculative geometry: 8 slots, prompts <= 16,
    horizon 192, chunks of 4, drafts of 3."""
    from apex_tpu_torch.serving import EngineConfig

    return EngineConfig(**{**dict(slots=SLOTS, max_prompt_len=16,
                                  max_seq_len=HORIZON, decode_chunk=4,
                                  spec_k=SPEC_K), **over})


def _first_gap(cfg, params, r, plain_toks, k: int, other=None) -> float:
    """Top-2 gap of the reference forward's scores at stream index ``k``
    of the plain stream: the logits for a greedy request, the
    temperature-scaled logits filtered by the request's top-k / top-p,
    plus the draw's Gumbel noise, for a sampled one (the quantity whose
    argmax picked the token). Given ``other``, the token another path drew
    there, a sampled request's gap is the decision's margin instead: the
    smaller of the two tokens' score gap (when the reference keeps both)
    and each token's scaled distance from the top-k threshold (a token at
    the threshold enters or leaves the draw at a rounding, and its noise
    then decides the draw)."""
    import dataclasses

    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import sampling

    ref_cfg = dataclasses.replace(cfg, attn_impl="xla")
    p = gpt.cast_params(ref_cfg, params)
    seq = torch.as_tensor([list(r.prompt) + plain_toks[:k]], device="cuda")
    lg = gpt.logits(ref_cfg, p, seq)[0, -1].float()
    sp = r.sampling
    if sp.temperature > 0:
        key = torch.tensor([sampling.request_key(sp.seed, 0)],
                           device="cuda")
        t = torch.tensor([len(r.prompt) - 1 + k], device="cuda")
        scaled = lg / sp.temperature
        kept = sampling.filter_logits_traced(
            scaled[None], torch.tensor([sp.top_k], device="cuda"),
            torch.tensor([sp.top_p], device="cuda"))[0]
        lg = kept.float() + sampling.gumbel_noise(
            key, t, torch.zeros_like(t), lg.numel())[0]
        if other is not None:
            pair = (plain_toks[k], other)
            margins = []
            if sp.top_k > 0:
                kth = float(torch.topk(scaled, sp.top_k).values[-1])
                margins += [abs(float(scaled[x]) - kth) for x in pair]
            if all(bool(kept[x] > torch.finfo(kept.dtype).min)
                   for x in pair):
                margins.append(abs(float(lg[pair[0]] - lg[pair[1]])))
            return min(margins)
    top = torch.topk(lg, 2).values
    return float(top[0] - top[1])


def phase_spec(cfg, params, band: float):
    """bench's speculative A/B: each trace through a spec_k=3 engine and a
    plain one under the scheduler (the spec side's payoff gate picks each
    chunk's kind), in the order spec, plain, plain, spec for the two
    sides' decode tokens/s in one call. On each side's first run every
    spec stream must hold the reference band, and the verify launch (the
    column write inside the T-row read) must run on every layer of every
    verify wave, the stand-alone write on none. The spec-vs-plain drift is
    reported, not asserted (the verify's projections multiply T rows at
    once and round otherwise than the decode step's), with the top-2 gap
    at each drifting stream's first divergence."""
    L = cfg.num_layers
    out, writes = {}, {}
    for trace, adv in (("high", False), ("adv", True)):
        res, tps = {}, {"spec": [], "plain": []}
        for side in ("spec", "plain", "plain", "spec"):
            reqs = spec_trace(cfg.vocab_size, adv)
            engine, sched, wall, counts = serve_timed(
                cfg, params,
                spec_config() if side == "spec" else spec_config(spec_k=0),
                reqs)
            s = sched.summary()
            tps[side].append(s["decode_tokens_per_sec"])
            if side in res:
                del engine, sched
                continue
            check(len(sched.completions) == len(reqs),
                  f"spec {trace}/{side}: not every request completed")
            row = dict(wall_s=wall,
                       decode_tokens_per_sec=s["decode_tokens_per_sec"],
                       decode_time_s=s["decode_time_s"],
                       decode_steps=engine.decode_steps_taken,
                       verify_waves=engine.spec_waves_taken)
            if side == "spec":
                check(counts["decode_verify_attention"]
                      == L * engine.spec_waves_taken > 0
                      and counts["cache_write_columns"] == 0
                      and counts["paged_verify_attention"] == 0,
                      f"spec {trace}: decode_verify_attention launched "
                      f"{counts['decode_verify_attention']} times, expected "
                      f"{L} x {engine.spec_waves_taken} verify waves "
                      f"(cache_write_columns "
                      f"{counts['cache_write_columns']}, paged "
                      f"{counts['paged_verify_attention']})")
                writes[trace] = {k: counts[k] for k in (
                    "decode_verify_attention", "cache_write_columns")}
                worst_lp, worst_gap = hold_streams(cfg, params, reqs,
                                                   sched.completions)
                check(worst_lp <= band and worst_gap <= band,
                      f"spec {trace}: streams off the reference by "
                      f"{worst_lp} / {worst_gap} (band {band})")
                row.update(
                    max_logprob_err=worst_lp, greedy_gap=worst_gap,
                    **{k: s[k] for k in (
                        "spec_chunks", "spec_tokens_per_wave",
                        "spec_accept_rate", "spec_gate_state",
                        "spec_break_even", "spec_gate_spec_decisions",
                        "spec_gate_plain_decisions")})
            res[side] = (row, {r: c.tokens
                               for r, c in sched.completions.items()})
            del engine, sched
        spec_t, plain_t = res["spec"][1], res["plain"][1]
        gaps = []
        for r in spec_trace(cfg.vocab_size, adv):
            a, b = spec_t[r.request_id], plain_t[r.request_id]
            if a != b:
                k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                gaps.append((r.request_id, k,
                             _first_gap(cfg, params, r, b, k)))
        out[trace] = dict(spec=res["spec"][0], plain=res["plain"][0],
                          decode_tokens_per_sec=tps,
                          spec_over_plain=sum(tps["spec"])
                          / sum(tps["plain"]),
                          drift=len(gaps), first_divergence_gaps=gaps)
        log(f"spec {trace}: " + json.dumps(out[trace]))
    return writes, out


def drive_spec(engine, reqs):
    """Serve ``reqs`` with every chunk speculative, without the scheduler:
    ``admit_many`` into free slots in FIFO order, then
    ``step_async(spec=True).fetch()`` and only the ``valid`` columns.
    Returns each request's tokens."""
    from apex_tpu_torch.serving import Admission

    queue, free = list(reqs), list(range(engine.slots))[::-1]
    active, out = {}, {r.request_id: [] for r in reqs}

    def release(slot):
        engine.free_slot(slot)
        del active[slot]
        free.append(slot)

    while queue or active:
        adm = []
        while queue and free:
            adm.append((free.pop(), queue.pop(0)))
        if adm:
            res = engine.admit_many([Admission(
                slot=slot, prompt=r.prompt, max_tokens=r.max_tokens,
                temperature=r.sampling.temperature, seed=r.sampling.seed)
                for slot, r in adm])
            for (slot, r), a in zip(adm, res):
                out[r.request_id].append(a.first_token)
                active[slot] = r
                if a.finished:
                    release(slot)
        if not active:
            continue
        h = engine.step_async(spec=True)
        toks, _, fins = h.fetch()
        for j in range(toks.shape[1]):
            for slot in list(active):
                if h.valid[slot, j]:
                    out[active[slot].request_id].append(int(toks[slot, j]))
                    if fins[slot, j]:
                        release(slot)
    return out


def phase_paged_spec(cfg, params):
    """The "high" trace with every chunk speculative through a paged
    spec_k=3 engine and a contiguous one: the emitted tokens must be
    identical (the paged verify launch returns the contiguous one's bits
    on the same bytes), each side's verify launch must run on every layer
    of every wave and no stand-alone multi-column write anywhere. Returns
    the paged side's launch counts."""
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Engine

    L = cfg.num_layers
    reqs = spec_trace(cfg.vocab_size, False)
    res = {}
    for name, ecfg in (("paged", spec_config(page_size=PAGE)),
                       ("contig", spec_config())):
        engine = Engine(cfg, params, ecfg)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        toks = drive_spec(engine, reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        waves = engine.spec_waves_taken
        want = {"paged": ("paged_verify_attention",
                          "decode_verify_attention"),
                "contig": ("decode_verify_attention",
                           "paged_verify_attention")}
        on, off = want[name]
        check(counts[on] == L * waves > 0 and counts[off] == 0
              and counts["cache_write_columns"] == 0
              and counts["paged_write_columns"] == 0,
              f"paged+spec {name}: {on} launched {counts[on]} times "
              f"(expected {L} x {waves} waves), {off} {counts[off]}, the "
              f"multi-column writes {counts['cache_write_columns']} / "
              f"{counts['paged_write_columns']}")
        check(counts["decode_attention"] == counts["paged_attention"] == 0
              and counts["decode_attention_write"] == 0
              and counts["paged_attention_write"] == 0,
              f"paged+spec {name}: a plain decode read or a fused decode "
              f"step ran")
        check(all(len(toks[r.request_id]) == r.max_tokens for r in reqs),
              f"paged+spec {name}: a stream is short")
        res[name] = (toks, counts, wall, waves)
        del engine
    drift = [r for r in res["paged"][0]
             if res["paged"][0][r] != res["contig"][0][r]]
    check(not drift, f"paged+spec: streams differ from contiguous spec for "
          f"{drift}")
    log(f"paged+spec: 16 streams identical to contiguous spec; paged "
        f"{res['paged'][2]:.2f}s / {res['paged'][3]} waves, contiguous "
        f"{res['contig'][2]:.2f}s / {res['contig'][3]} waves")
    return res["paged"][1]


# ---------------------------------------------------------------------------
# phase 36: prefix reuse and long prompts — the shared-prefix pool (with
# copy-on-write pages), chunked prefill and the pipelined scheduler
# ---------------------------------------------------------------------------

#: bench.py serve()'s prefix A/B geometry: prompts <= 128 (twice phase 5's),
#: horizon 144, chunks of 8; a 64-token template with tails of 1-8 tokens
PREFIX_GEOM = dict(slots=SLOTS, max_prompt_len=128, max_seq_len=144,
                   decode_chunk=8)
PREFIX_LEN = 64
#: bench.py serve()'s chunked A/B geometry: one 256-token prompt admitted
#: in chunks of 64 ahead of 7 short ones
CHUNK_GEOM = dict(slots=SLOTS, max_prompt_len=256, max_seq_len=288,
                  decode_chunk=8)
PREFILL_CHUNK = 64
#: bench's scheduler for both A/Bs (admissions one at a time, so TTFT is
#: one admission's latency) and its rounds, the sides' order alternating
AB_SCHED = dict(pipeline_depth=2, max_admit_batch=1)
AB_ROUNDS = 3


def prefix_template(vocab: int):
    """bench.py serve()'s shared template: 64 tokens, numpy seed 900."""
    return np.random.default_rng(900).integers(0, vocab, PREFIX_LEN).tolist()


def prefix_trace(vocab: int, n: int = 32):
    """bench.py serve()'s prefix trace: the template and a tail of ``1 + i
    % 8`` tokens (numpy seed ``910 + i``), 8 tokens each, odd requests
    sampled at temperature 0.9 with top-k 40 and seed ``i``."""
    from apex_tpu_torch.serving import Request, SamplingParams

    template = prefix_template(vocab)
    reqs = []
    for i in range(n):
        tail = np.random.default_rng(910 + i).integers(
            0, vocab, 1 + i % 8).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=40, seed=i) if i % 2
              else SamplingParams())
        reqs.append(Request(f"p{i}", template + tail, max_tokens=8,
                            sampling=sp))
    return reqs


def chunk_trace(vocab: int, with_long: bool):
    """bench.py serve()'s chunked trace: a 256-token greedy prompt (numpy
    seed 600) first when ``with_long``, then 7 short ones of ``1 + i % 8``
    tokens (seed ``610 + i``), 8 tokens each, odd ones sampled."""
    from apex_tpu_torch.serving import Request, SamplingParams

    reqs = []
    if with_long:
        reqs.append(Request("long", np.random.default_rng(600).integers(
            0, vocab, CHUNK_GEOM["max_prompt_len"]).tolist(), max_tokens=8))
    for i in range(SLOTS - 1):
        prompt = np.random.default_rng(610 + i).integers(
            0, vocab, 1 + i % 8).tolist()
        sp = (SamplingParams(temperature=0.9, top_k=40, seed=i) if i % 2
              else SamplingParams())
        reqs.append(Request(f"c{i}", prompt, max_tokens=8, sampling=sp))
    return reqs


#: the engine's counters a run's deltas are read from
ENGINE_COUNTERS = ("decode_steps_taken", "spec_waves_taken", "admit_groups",
                   "prefix_admits", "chunk_prefills")


def serve_counted(engine, reqs, **sched_kw):
    """Serve ``reqs`` (all at t=0) through a new ``Scheduler(engine,
    **sched_kw)`` with the launch counts zeroed just before and read just
    after: returns the scheduler, the wall time, the counts, the engine
    counters' deltas and the streams."""
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Scheduler

    sched = Scheduler(engine, **sched_kw)
    before = {k: getattr(engine, k) for k in ENGINE_COUNTERS}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    delta = {k: getattr(engine, k) - v for k, v in before.items()}
    check(len(sched.completions) == len(reqs)
          and all(len(sched.completions[r.request_id].tokens)
                  == r.max_tokens for r in reqs),
          f"{sched_kw}: not every request completed in full")
    return (sched, wall, counts, delta,
            {k: c.tokens for k, c in sched.completions.items()})



def check_prefills(what, counts, delta, L, chunk0: int = 0) -> None:
    """Row 5 (flash, on its tensor-core kernel) on every layer of every
    cold admission group and every chunk 0, and nowhere else: a prefix
    hit's extend and the later chunks run the materialised scores."""
    want = L * (delta["admit_groups"] + chunk0)
    check(counts["flash_attention_bsh"] == want,
          f"{what}: flash_attention_bsh launched "
          f"{counts['flash_attention_bsh']} times, expected {L} x "
          f"({delta['admit_groups']} groups + {chunk0} chunk 0s)")
    check_tc(what, counts, "flash_attention_bsh")


def _pinned(engine):
    """Both planes of every cache page a registered prefix pins."""
    pages = [p for ps in engine._prefix_pages.values() for p in ps]
    return {k: v[:, :, pages].clone() for k, v in (
        engine.cache.items() if isinstance(engine.cache, dict)
        else (("kv", engine.cache),))}


def _check_shared(what, engine, before) -> None:
    """The pinned prefix pages bit-unchanged, only they in use after the
    drain, none shared."""
    after = _pinned(engine)
    check(all(torch.equal(_bits(after[k]), _bits(before[k]))
              for k in before), f"{what}: a shared prefix page was written")
    ps = engine.page_stats()
    n = sum(len(p) for p in engine._prefix_pages.values())
    check(ps["pages_in_use"] == n and ps["pages_shared"] == 0,
          f"{what}: {ps['pages_in_use']} pages in use / "
          f"{ps['pages_shared']} shared after the drain, expected the "
          f"{n} pinned / 0")


def phase_prefix_chunked(cfg, params, band: float, card: str):
    """bench's two admission A/Bs on the serving model, and the pipelined
    scheduler against the serial one. Returns the launch counts of rows 5,
    10, 17 and 15v summed over the phase's runs, and the numbers; each
    line of numbers names ``card`` (its name and power limit).

    (a) the prefix A/B, contiguous, at ``pipeline_depth=2,
    max_admit_batch=1``: a pool of one template against cold prefill, the
    sides alternating over AB_ROUNDS rounds: TTFT means, the median of the
    per-round cold / hit ratios, hits and misses; the hit side launches no
    flash prefill and 32 extends, the cold side row 5 on every layer of
    its 32 admissions; reruns identical; every hit stream within the
    reference band; hit vs cold drift (flash against the materialised
    scores) with each first divergence's gap at most ``band``.
    (b) copy-on-write at pages of 8: two waves of the trace, each stream
    bit-identical to (a)'s pooled hits, ``page_share_hits ==
    prefix_hits``, the pinned prefix pages bit-unchanged by the paged
    decode launches, only they in use after the drain; then with
    ``spec_k=3`` (every chunk after the first plain one speculative: the
    paged verify launch writes through the table too); then int8, pooled
    and copy-on-write: identical, the pinned int8 pages unchanged.
    (c) the chunked A/B: the shorts' TTFT inflation over a shorts-only
    baseline, monolithic against ``prefill_chunk=64``, the sides
    alternating; ``chunked_admissions`` 1 and ``chunked_chunks`` 4; row 5
    for each cold group and chunk 0; mono vs chunked drift with each gap
    at most ``band``.
    (d) phase 5's trace at depth 1 and depth 2: identical streams, the
    host ms a decode step on each side."""
    import dataclasses

    from apex_tpu_torch.serving import Engine, EngineConfig, SpecGateConfig

    L, V = cfg.num_layers, cfg.vocab_size
    out = {}
    launches = dict(flash_attention_bsh=0, decode_attention_write=0,
                    paged_attention_write=0, paged_verify_attention=0)

    def tally(counts):
        for k in launches:
            launches[k] += counts[k]

    # (a) the prefix A/B
    template = prefix_template(V)
    hit_eng = Engine(cfg, params, EngineConfig(**PREFIX_GEOM,
                                               prefix_pool_slots=1))
    check(hit_eng.register_prefix(template) == 0
          and hit_eng.prefix_splits[-1] == PREFIX_LEN,
          f"prefix: the template pooled at {hit_eng.prefix_splits}")
    cold_eng = Engine(cfg, params, EngineConfig(**PREFIX_GEOM))
    sides = (("hit", hit_eng), ("cold", cold_eng))
    streams, ttft, ratios, runs = {}, {"hit": [], "cold": []}, [], {}
    comps = {}
    for rnd in range(AB_ROUNDS):
        per = {}
        for name, eng in (sides if rnd % 2 == 0 else sides[::-1]):
            sched, wall, counts, delta, toks = serve_counted(
                eng, prefix_trace(V), **AB_SCHED)
            s = sched.summary()
            per[name] = s["ttft_mean_ms"]
            ttft[name].append(s["ttft_mean_ms"])
            if name in streams:
                check(toks == streams[name], f"prefix {name}: a rerun's "
                      f"streams differ")
                continue
            streams[name], comps[name] = toks, sched.completions
            tally(counts)
            check_decode_step_kernels(f"prefix {name}", counts,
                                      ("decode_attention_write",),
                                      delta["decode_steps_taken"], L)
            check_prefills(f"prefix {name}", counts, delta, L)
            hits = 32 if name == "hit" else 0
            check(s["prefix_hits"] == hits and delta["prefix_admits"] == hits
                  and delta["admit_groups"] == 32 - hits
                  and s["prefix_misses"] == 0,
                  f"prefix {name}: {s['prefix_hits']} hits, "
                  f"{s['prefix_misses']} misses, {delta}")
            runs[name] = dict(wall_s=wall, ttft_mean_ms=s["ttft_mean_ms"],
                              ttft_p99_ms=s["ttft_p99_ms"],
                              decode_tokens_per_sec=s[
                                  "decode_tokens_per_sec"],
                              prefix_hits=s["prefix_hits"],
                              prefix_misses=s["prefix_misses"], **delta)
        ratios.append(per["cold"] / per["hit"])
    worst_lp, worst_gap = hold_streams(cfg, params, prefix_trace(V),
                                       comps["hit"])
    check(worst_lp <= band and worst_gap <= band,
          f"prefix hit: streams off the reference by {worst_lp} / "
          f"{worst_gap} (band {band})")
    gaps = _drift_gaps(cfg, params, prefix_trace(V), streams["hit"],
                       streams["cold"])
    check(all(g <= band for _, _, g in gaps),
          f"prefix: hit vs cold diverge past the band {band}: {gaps}")
    out["prefix_ab"] = dict(
        split=PREFIX_LEN, cold_bucket=cold_eng.bucket_for(PREFIX_LEN + 1),
        tail_bucket=hit_eng.bucket_for(8), runs=runs,
        ttft_mean_ms=ttft, ttft_speedup=statistics.median(ratios),
        round_ratios=ratios, pool_bytes=hit_eng.pool_bytes(),
        max_logprob_err=worst_lp, greedy_gap=worst_gap, drift=len(gaps),
        first_divergence_gaps=gaps)
    log(f"prefix A/B ({card}): " + json.dumps(out["prefix_ab"]))
    pooled = streams["hit"]
    del hit_eng, cold_eng

    # (b) copy-on-write, then with speculation, then int8
    cow = {}
    paged_cfg = EngineConfig(**PREFIX_GEOM, prefix_pool_slots=1,
                             page_size=PAGE)
    eng = Engine(cfg, params, paged_cfg)
    eng.register_prefix(template)
    before = _pinned(eng)
    for wave in (1, 2):
        sched, wall, counts, delta, toks = serve_counted(
            eng, prefix_trace(V), **AB_SCHED)
        s = sched.summary()
        tally(counts)
        check(toks == pooled, f"cow wave {wave}: streams differ from the "
              f"pooled hits' for {[r for r in toks if toks[r] != pooled[r]]}")
        check(s["page_share_hits"] == s["prefix_hits"] == 32,
              f"cow wave {wave}: {s['page_share_hits']} shared of "
              f"{s['prefix_hits']} hits")
        check_decode_step_kernels(f"cow wave {wave}", counts,
                                  ("paged_attention_write",),
                                  delta["decode_steps_taken"], L)
        check_prefills(f"cow wave {wave}", counts, delta, L)
        _check_shared(f"cow wave {wave}", eng, before)
        cow[f"wave{wave}"] = dict(wall_s=wall,
                                  ttft_mean_ms=s["ttft_mean_ms"],
                                  page_share_hits=s["page_share_hits"],
                                  pages_in_use=s["pages_in_use"], **delta)
    del eng
    eng = Engine(cfg, params, dataclasses.replace(
        paged_cfg, decode_chunk=4, spec_k=SPEC_K))
    eng.register_prefix(template)
    before = _pinned(eng)
    sched, wall, counts, delta, toks = serve_counted(
        eng, prefix_trace(V), spec_gate=SpecGateConfig(
            min_probe_chunks=1 << 30), **AB_SCHED)
    tally(counts)
    waves = delta["spec_waves_taken"]
    check(counts["paged_verify_attention"] == L * waves > 0
          and counts["paged_write_columns"] == 0
          and counts["decode_verify_attention"] == 0,
          f"cow spec: paged_verify_attention launched "
          f"{counts['paged_verify_attention']} times, expected {L} x "
          f"{waves} waves")
    check_decode_step_kernels("cow spec", counts, ("paged_attention_write",),
                              delta["decode_steps_taken"], L,
                              allow_no_steps=True)
    _check_shared("cow spec", eng, before)
    spec_gaps = _drift_gaps(cfg, params, prefix_trace(V), toks, pooled)
    cow["spec"] = dict(wall_s=wall, verify_waves=waves,
                       drift=len(spec_gaps),
                       first_divergence_gaps=spec_gaps, **delta)
    del eng
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    q_streams = {}
    for name, ecfg in (("pooled", dataclasses.replace(paged_cfg,
                                                      page_size=0)),
                       ("cow", paged_cfg)):
        eng = Engine(cfg8, params, ecfg)
        eng.register_prefix(template)
        before = _pinned(eng) if eng.paged else None
        sched, wall, counts, delta, toks = serve_counted(
            eng, prefix_trace(V), **AB_SCHED)
        on = (("paged_write_column_quant", "paged_attention_quant")
              if eng.paged else
              ("decode_write_column_quant", "decode_attention_quant"))
        _check_quant_counts(f"int8 {name}", counts, on,
                            delta["decode_steps_taken"], L)
        if eng.paged:
            _check_shared("int8 cow", eng, before)
            check(sched.summary()["page_share_hits"] == 32,
                  "int8 cow: not every hit shared the prefix pages")
        q_streams[name] = toks
        del eng
    check(q_streams["cow"] == q_streams["pooled"],
          "int8: copy-on-write streams differ from the pooled hits'")
    q_gaps = _drift_gaps(cfg, params, prefix_trace(V), q_streams["cow"],
                         pooled)
    cow["int8"] = dict(drift_vs_compute=len(q_gaps),
                       first_divergence_gaps=q_gaps)
    out["cow"] = cow
    log(f"copy-on-write ({card}): " + json.dumps(cow))

    # (c) the chunked A/B
    mono = Engine(cfg, params, EngineConfig(**CHUNK_GEOM))
    chunked = Engine(cfg, params, EngineConfig(
        **CHUNK_GEOM, prefill_chunk=PREFILL_CHUNK))
    sides = (("mono", mono), ("chunked", chunked))
    streams, comps, runs = {}, {}, {}
    infl = {"mono": [], "chunked": []}
    short_ms = {"base": [], "mono": [], "chunked": []}

    def shorts_ms(sched):
        return 1e3 * statistics.mean(
            c.ttft for rid, c in sched.completions.items() if rid != "long")

    for rnd in range(AB_ROUNDS):
        sched, *_ = serve_counted(mono, chunk_trace(V, False), **AB_SCHED)
        base = shorts_ms(sched)
        short_ms["base"].append(base)
        for name, eng in (sides if rnd % 2 == 0 else sides[::-1]):
            sched, wall, counts, delta, toks = serve_counted(
                eng, chunk_trace(V, True), **AB_SCHED)
            ms = shorts_ms(sched)
            short_ms[name].append(ms)
            infl[name].append(ms / base)
            if name in streams:
                check(toks == streams[name], f"chunked {name}: a rerun's "
                      f"streams differ")
                continue
            streams[name], comps[name] = toks, sched.completions
            tally(counts)
            s = sched.summary()
            check_decode_step_kernels(f"chunked {name}", counts,
                                      ("decode_attention_write",),
                                      delta["decode_steps_taken"], L)
            if name == "chunked":
                check(s["chunked_admissions"] == 1
                      and s["chunked_chunks"] == 4
                      and delta["chunk_prefills"] == 4,
                      f"chunked: {s['chunked_admissions']} admissions, "
                      f"{s['chunked_chunks']} chunks, {delta}")
            check_prefills(f"chunked {name}", counts, delta, L,
                           chunk0=1 if name == "chunked" else 0)
            runs[name] = dict(wall_s=wall, long_ttft_ms=1e3 * sched.
                              completions["long"].ttft, **delta)
    worst_lp, worst_gap = hold_streams(cfg, params, chunk_trace(V, True),
                                       comps["chunked"])
    check(worst_lp <= band and worst_gap <= band,
          f"chunked: streams off the reference by {worst_lp} / {worst_gap} "
          f"(band {band})")
    gaps = _drift_gaps(cfg, params, chunk_trace(V, True),
                       streams["chunked"], streams["mono"])
    check(all(g <= band for _, _, g in gaps),
          f"chunked: mono vs chunked diverge past the band {band}: {gaps}")
    out["chunked_ab"] = dict(
        long_prompt=CHUNK_GEOM["max_prompt_len"],
        prefill_chunk=PREFILL_CHUNK, short_ttft_ms=short_ms,
        ttft_inflation_mono=statistics.median(infl["mono"]),
        ttft_inflation_chunked=statistics.median(infl["chunked"]),
        inflation_rounds=infl, runs=runs, max_logprob_err=worst_lp,
        greedy_gap=worst_gap, drift=len(gaps), first_divergence_gaps=gaps)
    log(f"chunked A/B ({card}): " + json.dumps(out["chunked_ab"]))
    del mono, chunked, sides

    # (d) depth 1 against depth 2 on phase 5's trace
    eng = Engine(cfg, params, EngineConfig(slots=SLOTS, max_prompt_len=64,
                                           max_seq_len=HORIZON))
    depth = {}
    for d in (1, 2):
        sched, wall, counts, delta, toks = serve_counted(
            eng, bench_trace(V), pipeline_depth=d)
        tally(counts)
        check_decode_step_kernels(f"depth {d}", counts,
                                  ("decode_attention_write",),
                                  delta["decode_steps_taken"], L)
        s = sched.summary()
        steps = delta["decode_steps_taken"]
        depth[d] = dict(wall_s=wall, decode_steps=steps,
                        host_ms_per_decode_step=wall * 1e3 / steps,
                        decode_ms_per_step=s["decode_time_s"] * 1e3 / steps,
                        decode_tokens_per_sec=s["decode_tokens_per_sec"],
                        tokens_per_sec=s["tokens_per_sec"],
                        ttft_mean_ms=s["ttft_mean_ms"], streams=toks)
    check(depth[2]["streams"] == depth[1]["streams"],
          "depth 2: streams differ from depth 1's for "
          f"{[r for r in depth[1]['streams'] if depth[1]['streams'][r] != depth[2]['streams'].get(r)]}")
    for d in depth.values():
        del d["streams"]
    out["depth"] = depth
    log(f"pipeline depth 1 vs 2 ({card}): " + json.dumps(depth))
    del eng
    out["launches"] = launches
    log(f"prefix/chunked launches ({card}): " + json.dumps(launches))
    return launches, out


# ---------------------------------------------------------------------------
# phase 37: the serving front end on the card
# ---------------------------------------------------------------------------

#: phase 37's geometry: serve()'s 8 slots and horizon 192, prompts up to
#: 128 (serve() admits 64; byte-level chat prompts need the room), one
#: token a decode dispatch (the constrained requests need it)
API_GEOM = dict(slots=SLOTS, max_prompt_len=128, max_seq_len=HORIZON,
                decode_chunk=1)
#: the fair-share weights of (d), and a tenant at 2 tokens/s with a 4 s
#: burst (one request of 8 tokens passes, the next waits seconds)
API_WEIGHTS = {"gold": 3.0, "bronze": 1.0}
API_TIGHT = "tight"
API_CHAT_NEW = 24
API_STOP_NEW = 16
API_SCHEMA_NEW = 96
API_TENANT_REQS = 16
API_TENANT_NEW = 16
#: (c)'s schemas: two objects with required keys, an array, an enum
API_SCHEMAS = (
    {"type": "object", "properties": {
        "name": {"type": "string", "maxLength": 8},
        "age": {"type": "integer"},
        "ok": {"type": "boolean"}},
     "required": ["name", "age", "ok"]},
    {"type": "object", "properties": {
        "id": {"type": "integer"},
        "tags": {"type": "array", "items": {"enum": ["a", "b", "c"]},
                 "minItems": 1, "maxItems": 3},
        "score": {"type": "number"}},
     "required": ["id", "tags"]},
    {"type": "array", "items": {"type": "integer"}, "minItems": 2,
     "maxItems": 4},
    {"enum": ["red", "green", "blue"]},
)
#: (f)'s constrained request: at least 12 integers (25 tokens or more), so
#: its slot stays constrained through a profile window
API_WINDOW_SCHEMA = {"type": "array", "items": {"type": "integer"},
                     "minItems": 12, "maxItems": 12}


def _http(port: int, path: str, body, headers=None, *, on_token=None):
    """POST ``body`` to the front end on 127.0.0.1. Returns ``(status,
    headers, payload)``: the JSON body, or for an SSE stream ``{"tokens",
    "finish", "text"}`` of choice 0, with ``on_token()`` called as each
    token arrives."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        hdrs = dict(resp.getheaders())
        if not hdrs.get("Content-Type", "").startswith("text/event-stream"):
            raw = resp.read()
            try:
                return resp.status, hdrs, json.loads(raw)
            except ValueError:
                return resp.status, hdrs, raw.decode("utf-8", "replace")
        toks, fins, text = [], [], ""
        while True:
            line = resp.readline()
            if not line or line.strip() == b"data: [DONE]":
                break
            if not line.startswith(b"data: "):
                continue
            for ch in json.loads(line[6:])["choices"]:
                ids = ch.get("token_ids") or []
                toks += ids
                text += (ch.get("delta") or {}).get("content", "") \
                    or ch.get("text", "")
                if ch.get("finish_reason"):
                    fins.append(ch["finish_reason"])
                if on_token is not None:
                    for _ in ids:
                        on_token()
        return resp.status, hdrs, dict(tokens=toks, finish=fins, text=text)
    finally:
        conn.close()


def _fits_schema(v, schema) -> bool:
    """Whether the JSON value ``v`` has ``schema``'s shape: types, the
    required keys, lengths and enum members."""
    if "enum" in schema:
        return v in schema["enum"]
    t = schema.get("type")
    if t == "object":
        return (isinstance(v, dict)
                and set(schema.get("required", ())) <= set(v)
                and set(v) <= set(schema["properties"])
                and all(_fits_schema(v[k], schema["properties"][k])
                        for k in v))
    if t == "array":
        return (isinstance(v, list)
                and schema.get("minItems", 0) <= len(v)
                <= schema.get("maxItems", len(v))
                and all(_fits_schema(x, schema["items"]) for x in v))
    if t == "string":
        return isinstance(v, str) and len(v) <= schema.get("maxLength",
                                                           len(v))
    if t == "integer":
        return isinstance(v, int) and not isinstance(v, bool)
    if t == "number":
        return isinstance(v, (int, float)) and not isinstance(v, bool)
    if t == "boolean":
        return isinstance(v, bool)
    return v is None


def _reference_trim(stream, stops):
    """An unstopped stream cut where a stop first completes, the stop
    excluded (the host reference of the stop matcher)."""
    for i in range(len(stream)):
        for stop in stops:
            if i + 1 >= len(stop) and \
                    stream[i + 1 - len(stop):i + 1] == list(stop):
                return stream[:i + 1 - len(stop)], True
    return list(stream), False


def _chat_messages(i: int):
    """Chat (a)'s messages: rendered, every prompt is 64 bytes."""
    from apex_tpu_torch.serving.api import render_chat_prompt

    head = f"Request {i:02d}: tell me about the serving front end"
    msgs = [{"role": "user", "content": head}]
    pad = 64 - len(render_chat_prompt(msgs))
    msgs[0]["content"] = head + "." * pad
    return msgs


def phase_api(cfg, params, band: float, card: str, prof5):
    """Phase 37: ``start_api_server`` on 127.0.0.1, port 0, over a card
    ``Engine`` (API_GEOM) and ``Scheduler`` (``pipeline_depth=2``,
    ``max_admit_batch=1``: every admission one request wide, so a stream
    does not depend on who shares its admission; the tenancy of (d)),
    driven through ``http.client``; the launch counts zeroed before (a)
    and read after (d). ``prof5`` is phase 6's profile of phase 5's
    engine. Returns the launch counts and the numbers; each line of
    numbers names ``card``.

    (a) eight concurrent greedy ``stream: true`` chat requests (64-byte
    rendered prompts, 24 tokens): each SSE stream of token ids equals the
    port's solo ``gpt.generate`` on the card (one batch of the eight
    prompts), or first diverges at a reference top-2 gap within ``band``
    (phase 20's rule: the solo run's GEMMs see other shapes), and its text
    is the byte decode of its ids.
    (b) ``/v1/completions`` with ``stop`` strings: two plain prompts and
    two ``json_object``-constrained ones (whose streams are bytes), each
    first unstopped, then with a stop string cut from its unstopped
    stream (a plain stream of the random model holds no text: two of its
    token ids as ``stop_token_ids`` then); the stopped output equals the
    reference trim of the unstopped one, ``finish_reason`` "stop".
    (c) four ``response_format: json_schema`` requests (API_SCHEMAS, two
    objects with required keys) at once: every output parses and fits
    its schema; the mask uploads counted.
    (d) 16 requests of tenant "gold" (weight 3) and 16 of "bronze"
    (weight 1) at once, streamed: each tenant's share of the first half
    of the streamed tokens; every stream equal to the same request served
    by one tenant afterwards (no drift); tenant "tight" (2 tokens/s, a 4
    s burst) gets a 429 with ``Retry-After`` on its second request.
    (e) the masked draw on the card: all-True masks bit-equal to no mask
    (greedy and sampled lanes), a one-token whitelist forcing its token
    greedy and sampled, the greedy masked draw equal to the argmax of
    the masked logits.
    (f) ``phase_profile``'s window (8 steps) on this engine with no
    constrained slot (its CUDA launches a decode step equal to phase 6's)
    and with one constrained slot, in turns (plain, constrained,
    constrained, plain): launches and host ms a decode step."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import (
        Engine,
        EngineConfig,
        Request,
        SamplingParams,
        Scheduler,
        TenancyConfig,
        sampling,
    )
    from apex_tpu_torch.serving.api import (
        ByteTokenizer,
        JsonSchemaConstraint,
        render_chat_prompt,
        start_api_server,
    )

    L, V = cfg.num_layers, cfg.vocab_size
    tok = ByteTokenizer(V)
    engine = Engine(cfg, params, EngineConfig(**API_GEOM))
    sched = Scheduler(engine, pipeline_depth=2, max_admit_batch=1,
                      tenancy=TenancyConfig(weights=API_WEIGHTS,
                                            rates={API_TIGHT: 2.0},
                                            burst_s=4.0))
    out = {}
    server = start_api_server(sched, port=0)
    port = server.port
    pool = ThreadPoolExecutor(max_workers=2 * API_TENANT_REQS)
    try:
        before = {k: getattr(engine, k) for k in ENGINE_COUNTERS}
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()

        # (a) eight concurrent streamed chat requests
        t = time.perf_counter()
        futs = [pool.submit(_http, port, "/v1/chat/completions", {
            "messages": _chat_messages(i), "max_tokens": API_CHAT_NEW,
            "stream": True, "return_token_ids": True})
            for i in range(SLOTS)]
        chat = [f.result() for f in futs]
        check(all(s == 200 for s, _, _ in chat),
              f"api (a): statuses {[s for s, _, _ in chat]}")
        for _, _, p in chat:
            check(p["finish"] == ["length"]
                  and len(p["tokens"]) == API_CHAT_NEW
                  and p["text"] == tok.decode(p["tokens"]),
                  f"api (a): a stream of {len(p['tokens'])} tokens "
                  f"finished {p['finish']}")
        out["chat_s"] = time.perf_counter() - t

        # (b) stop strings: unstopped, then stopped at a cut of the stream
        t = time.perf_counter()
        fmt = {"type": "json_object",
               "bounds": {"max_string_len": 6, "max_keys": 3,
                          "max_items": 2, "max_depth": 2}}
        cases = [("The card serves", None), ("Stop here, or there", None),
                 ("emit json", fmt), ("more json", fmt)]

        def completion(prompt, rf, **stop):
            body = {"prompt": prompt, "max_tokens": API_STOP_NEW,
                    "return_token_ids": True, **stop}
            if rf is not None:
                body["response_format"] = rf
            s, _, d = _http(port, "/v1/completions", body)
            check(s == 200, f"api (b): status {s}: {d}")
            return d["choices"][0]

        stops = []
        for prompt, rf in cases:
            full = completion(prompt, rf)["token_ids"]
            # a stop string: the first two printable bytes from token 2 on
            cut = next((full[i:i + 2] for i in range(2, len(full) - 1)
                        if all(32 <= x < 127 for x in full[i:i + 2])),
                       None)
            check(cut is not None or rf is None,
                  f"api (b): a constrained stream with no printable "
                  f"pair: {full}")
            if cut is None:
                # the random model's plain stream holds no text: stop on
                # two of its token ids instead
                cut = full[4:6]
                stop = dict(stop_token_ids=[cut])
            else:
                stop = dict(stop=[bytes(cut).decode("ascii"),
                                  "\x7fnever"])
            got = completion(prompt, rf, **stop)
            want, matched = _reference_trim(full, [cut])
            check(matched and got["token_ids"] == want
                  and got["finish_reason"] == "stop",
                  f"api (b): {prompt!r} {stop}: {got['token_ids']} "
                  f"finished {got['finish_reason']}, the reference trim "
                  f"of {full} is {want}")
            stops.append(dict(prompt=prompt, unstopped=len(full),
                              kept=len(want), **stop))
        check(sum("stop" in s for s in stops) >= 2,
              f"api (b): fewer than two stop strings: {stops}")
        out["stops"] = stops
        out["stops_s"] = time.perf_counter() - t

        # (c) four schemas at once
        t = time.perf_counter()
        uploads0 = engine.mask_uploads
        futs = [pool.submit(_http, port, "/v1/chat/completions", {
            "messages": [{"role": "user",
                          "content": f"emit json {i} for the schema"}],
            "max_tokens": API_SCHEMA_NEW,
            "response_format": {"type": "json_schema",
                                "json_schema": {"schema": schema}}})
            for i, schema in enumerate(API_SCHEMAS)]
        values = []
        for f, schema in zip(futs, API_SCHEMAS):
            s, _, d = f.result()
            check(s == 200, f"api (c): status {s}: {d}")
            ch = d["choices"][0]
            content = ch["message"]["content"]
            try:
                v = json.loads(content)
            except ValueError:
                raise SmokeFailure(f"api (c): {content!r} does not parse")
            check(ch["finish_reason"] == "stop" and _fits_schema(v, schema),
                  f"api (c): {content!r} ({ch['finish_reason']}) does not "
                  f"fit {schema}")
            values.append(content)
        out["schemas"] = dict(values=values,
                              mask_uploads=engine.mask_uploads - uploads0)
        out["schemas_s"] = time.perf_counter() - t
        log(f"api (c) ({card}): {json.dumps(out['schemas'])}")

        # (d) two tenants at 3:1, 16 requests each at once
        t = time.perf_counter()
        order, lock = [], threading.Lock()

        def note(tenant):
            def on_token():
                with lock:
                    order.append(tenant)
            return on_token

        tenant_reqs = [(tn, i) for i in range(API_TENANT_REQS)
                       for tn in ("gold", "bronze")]
        futs = [pool.submit(
            _http, port, "/v1/completions",
            {"prompt": f"{tn} tenant, request {i:02d}",
             "max_tokens": API_TENANT_NEW, "stream": True,
             "return_token_ids": True}, {"X-Tenant-Id": tn},
            on_token=note(tn)) for tn, i in tenant_reqs]
        tenant_streams = {}
        for (tn, i), f in zip(tenant_reqs, futs):
            s, _, p = f.result()
            check(s == 200 and len(p["tokens"]) == API_TENANT_NEW,
                  f"api (d): {tn} {i}: status {s}, {p}")
            tenant_streams[(tn, i)] = p["tokens"]
        half = order[:len(order) // 2]
        share = {tn: half.count(tn) / max(len(half), 1)
                 for tn in API_WEIGHTS}
        s, hdrs, d = _http(port, "/v1/completions", {
            "prompt": "tight", "max_tokens": 8}, {"X-Tenant-Id": API_TIGHT})
        check(s == 200, f"api (d): the tight tenant's first request: {s}")
        s, hdrs, d = _http(port, "/v1/completions", {
            "prompt": "tight again", "max_tokens": 8},
            {"X-Tenant-Id": API_TIGHT})
        check(s == 429 and int(hdrs.get("Retry-After", "0")) >= 1
              and d["error"]["code"] == "tenant_rate_limited",
              f"api (d): the tight tenant's second request: {s} {hdrs} {d}")
        out["tenants"] = dict(
            first_half_share=share, tokens=len(order),
            retry_after=hdrs["Retry-After"],
            summary={k: v for k, v in sched.tenant_summary().items()
                     if k in API_WEIGHTS or k == API_TIGHT})
        out["tenants_s"] = time.perf_counter() - t
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        delta = {k: getattr(engine, k) - v for k, v in before.items()}
    finally:
        server.stop()
        pool.shutdown()
    check(sched.idle(), "api: the scheduler is not idle after the phase")
    s = sched.summary()
    out.update(wall_s=wall, decode_steps=delta["decode_steps_taken"],
               admit_groups=delta["admit_groups"],
               stop_finishes=s["stop_finishes"],
               tenant_throttled=s["tenant_throttled"],
               tokens_emitted=s["tokens_emitted"])
    check_decode_step_kernels("api", counts, ("decode_attention_write",),
                              delta["decode_steps_taken"], L)
    check_prefills("api", counts, delta, L)
    out["launches"] = {k: counts[k] for k in ("flash_attention_bsh",
                                              "decode_attention_write")}
    log(f"api (a)-(d) ({card}): " + json.dumps(out))

    # (a) against the solo generate (after the counted window)
    msgs = [_chat_messages(i) for i in range(SLOTS)]
    prompts = [tok.encode(render_chat_prompt(m)) for m in msgs]
    solo = gpt.generate(cfg, gpt.cast_params(cfg, params),
                        torch.tensor(prompts, device="cuda"),
                        API_CHAT_NEW).tolist()
    reqs = [Request(f"c{i}", prompts[i], max_tokens=API_CHAT_NEW)
            for i in range(SLOTS)]
    gaps = _drift_gaps(cfg, params, reqs,
                       {f"c{i}": chat[i][2]["tokens"] for i in range(SLOTS)},
                       {f"c{i}": solo[i] for i in range(SLOTS)})
    check(all(g <= band for _, _, g in gaps),
          f"api (a): chat streams part from the solo generate past the "
          f"band {band}: {gaps}")
    out["chat_vs_solo"] = dict(identical=SLOTS - len(gaps),
                               first_divergence_gaps=gaps)
    log(f"api (a) vs solo generate ({card}): "
        + json.dumps(out["chat_vs_solo"]))

    # (d) against the same requests served by one tenant
    ref = Scheduler(engine, max_admit_batch=1)
    for tn, i in tenant_reqs:
        ref.submit(Request(f"{tn}{i}", tok.encode(
            f"{tn} tenant, request {i:02d}"), max_tokens=API_TENANT_NEW))
    ref.run_until_idle()
    drift = [k for k in tenant_reqs
             if ref.completions[f"{k[0]}{k[1]}"].tokens != tenant_streams[k]]
    check(not drift, f"api (d): streams drift from the one-tenant run: "
          f"{drift}")
    log(f"api (d) ({card}): first-half token shares "
        f"{json.dumps(share)}, weights {json.dumps(API_WEIGHTS)}, no drift "
        f"over {len(tenant_reqs)} streams, 429 Retry-After "
        f"{out['tenants']['retry_after']}")

    # (e) the masked draw on the card
    g = torch.Generator("cuda").manual_seed(37)
    lg = torch.randn(SLOTS, V, generator=g, device="cuda") * 3
    keys = torch.tensor([sampling.request_key(i, 0) for i in range(SLOTS)],
                        dtype=torch.int64, device="cuda")
    tt = torch.arange(SLOTS, device="cuda") + 9
    temp = torch.tensor([0.0, 0.9] * (SLOTS // 2), device="cuda")
    top_k = torch.tensor([0, 40, 0, 0] * (SLOTS // 4), device="cuda")
    top_p = torch.tensor([1.0, 1.0, 1.0, 0.9] * (SLOTS // 4),
                         device="cuda")
    draw = lambda m: sampling.draw_slots(lg, keys, tt, temp, top_k, top_p,
                                         masks=m)
    ones = torch.ones(SLOTS, V, dtype=torch.bool, device="cuda")
    check(torch.equal(draw(ones), draw(None)),
          "api (e): an all-True mask draws other tokens than no mask")
    forced = 4242 % V
    one = torch.zeros_like(ones)
    one[:, forced] = True
    check(bool((draw(one) == forced).all()),
          "api (e): a one-token whitelist did not force its token")
    rnd = torch.rand(SLOTS, V, generator=g, device="cuda") < 0.01
    rnd[:, 7] = True
    got = draw(rnd)
    masked = lg.masked_fill(~rnd, torch.finfo(lg.dtype).min)
    greedy = temp <= 0
    check(torch.equal(got[greedy], masked.argmax(-1)[greedy])
          and bool(rnd.gather(1, got[:, None]).all()),
          "api (e): a masked draw left its mask or its greedy argmax")
    out["masked_draw"] = "held"
    log(f"api (e) ({card}): all-True == no mask, a one-token whitelist "
        f"forced greedy and sampled, greedy masked draw == argmax")

    # (f) a decode step with and without a constrained slot, in turns
    def window_reqs(constrained: bool):
        reqs = bench_trace(V, n=SLOTS, max_tokens=40, seed0=5000)
        if constrained:
            reqs[0].constraint = JsonSchemaConstraint(API_WINDOW_SCHEMA)
        return reqs

    turns = []
    for side in ("plain", "constrained", "constrained", "plain"):
        u0 = engine.mask_uploads
        p = phase_profile(cfg, engine, chunks=8,
                          reqs=window_reqs(side != "plain"),
                          what=f"api (f) {side}")
        check(p is not None, "api (f): the profiler saw no kernel")
        turns.append(dict(side=side, mask_uploads=engine.mask_uploads - u0,
                          **{k: p[k] for k in (
                              "decode_steps", "host_ms_per_decode_step",
                              "launches_per_decode_step",
                              "device_idle_share")}))
    plain = [x for x in turns if x["side"] == "plain"]
    if prof5 is not None:
        check(all(x["launches_per_decode_step"]
                  == prof5["launches_per_decode_step"] for x in plain),
              f"api (f): an unconstrained decode step launched "
              f"{[x['launches_per_decode_step'] for x in plain]}, phase 6 "
              f"{prof5['launches_per_decode_step']}")
    out["decode_step"] = dict(
        phase6_launches=None if prof5 is None
        else prof5["launches_per_decode_step"],
        phase6_host_ms=None if prof5 is None
        else prof5["host_ms_per_decode_step"], turns=turns)
    log(f"api (f) ({card}): " + json.dumps(out["decode_step"]))
    return out["launches"], out



# ---------------------------------------------------------------------------
# phase 38: beam search and multi-LoRA serving
# ---------------------------------------------------------------------------

#: (a): two 32-token prompts, 32 new tokens, 4 beams (a decode batch of 8)
BEAM_PROMPT, BEAM_NEW, BEAMS = 32, 32, 4
#: (b)-(d): serve()'s geometry, one admission at a time, a pool of the base
#: row and two adapters (seeds 7 and 9, as JAX's tests/test_tenancy.py) of
#: rank 8 at alpha 16; 24 greedy requests of 32 tokens on adapters i % 3
LORA_GEOM = dict(slots=SLOTS, max_prompt_len=64, max_seq_len=HORIZON)
LORA_POOL = dict(adapter_slots=3, adapter_rank=8, adapter_alpha=16.0)
LORA_SEEDS = (7, 9)
LORA_REQS, LORA_NEW = 24, 32
#: (c): the paged spec engine serves the first 12; the gate probes the
#: other chunk kind every 2 chunks, so both kinds run
LORA_SPEC_REQS = 12


def lora_trace(vocab: int, n: int = LORA_REQS, adapters: bool = True):
    """(b)'s trace: request ``i`` on adapter ``i % 3`` (all on the base
    adapter with ``adapters=False``), a prompt of ``16 (1 + (i // 3) %
    4)`` tokens from seed ``3800 + i``, greedy, LORA_NEW tokens: each
    adapter's requests come in pairs of equal length, batched by the
    reference ``generate``."""
    from apex_tpu_torch.serving import Request

    reqs = []
    for i in range(n):
        p_len = 16 * (1 + (i // 3) % 4)
        prompt = np.random.default_rng(3800 + i).integers(
            0, vocab, p_len).tolist()
        reqs.append(Request(f"l{i}", prompt, max_tokens=LORA_NEW,
                            adapter=i % 3 if adapters else 0))
    return reqs


def _tf_logprobs(cfg, params, prompt, toks):
    """Teacher-forced fp32 log-probabilities of ``toks`` after ``prompt``
    through the reference forward ("xla" attention)."""
    import dataclasses

    from apex_tpu_torch.models import gpt

    ref_cfg = dataclasses.replace(cfg, attn_impl="xla")
    seq = torch.as_tensor([list(prompt) + list(toks[:-1])], device="cuda")
    lg = gpt.logits(ref_cfg, gpt.cast_params(ref_cfg, params), seq)[0]
    lp = torch.log_softmax(lg[len(prompt) - 1:].float(), -1)
    return lp.gather(1, torch.as_tensor(toks, device="cuda")[:, None])[:, 0]


def _api_launches(fn) -> int:
    """The CUDA API launch calls (``cudaLaunchKernel`` and kin, as the
    profiler names them) of one call of ``fn``, after a warm one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CPU and LAUNCH_API.match(e.key))


def _beam_launches(cfg, p, prompts, n_new: int, reps: int = 3):
    """The CUDA API launch calls of one ``beam_search`` call and the
    host's wall ms (unprofiled) of ``reps`` calls, after a warm one."""
    from apex_tpu_torch.models import gpt

    run = lambda: gpt.beam_search(cfg, p, prompts, n_new, num_beams=BEAMS)
    run()
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return _api_launches(run), walls


def _gaps_by_adapter(cfg, merged, reqs, got, want):
    """``_drift_gaps`` with each request's reference forward over its
    adapter's merged weights (``merged[a]``; the base params at 0)."""
    out = []
    for a in sorted(merged):
        rs = [r for r in reqs if r.adapter == a]
        out += [(rid, a, k, g) for rid, k, g in _drift_gaps(
            cfg, merged[a], rs, got, want)]
    return out


def phase_beam_lora(cfg, params, band: float, card: str, prof5):
    """Phase 38: beam search and multi-LoRA serving on the serving model.
    ``prof5`` is phase 6's profile. Returns the launch counts of (a)'s
    beam search, (b)'s mixed run and (c)'s paged spec run, and the
    numbers; each line of numbers names ``card``.

    (a) ``gpt.beam_search`` over two BEAM_PROMPT-token prompts, BEAM_NEW
    new tokens: ``num_beams=1`` equals ``gpt.generate``'s greedy stream;
    at BEAMS beams (the counts zeroed before, read after: row 5 once a
    layer, the fused decode launch once a layer a step) the beams are
    sorted and each score is its sequence's teacher-forced total
    log-probability within BEAM_NEW x ``band``; with an eos that fires, a
    frozen beam emits only pad after it and its score is the
    teacher-forced sum up to the eos (within ``band`` a token); the
    launches (CUDA API calls) and host ms a beam step, from a 32-token
    and a 2-token call's difference (the median of 3 calls each), and
    the reorder's launches and device ms (a CUDA graph of its calls).
    (b) Scheduler over a pool Engine (LORA_GEOM, LORA_POOL,
    ``max_admit_batch=1``), adapters of LORA_SEEDS, lora_trace's 24
    requests (counts zeroed before, read after): the base rows' streams
    equal a pool-less engine's bit for bit; each adapter's requests
    served alone give the mixed run's streams bit for bit; adapter
    streams equal ``gpt.generate`` over ``merge_lora``, or part from it
    where the merged reference's top-2 gap is within ``band`` (logged);
    some adapter stream differs from its base stream; phase 6's window
    on this engine with base rows only (its launches a decode step must
    equal phase 6's) and with adapter rows, in turns; ``adapter_bytes``.
    (c) a paged (pages of 8) ``spec_k=3`` pool engine on the first 12
    requests (the gate probing every 2 chunks): paged fused decode steps
    (rows 13 + 17) and paged verify waves (15v) on every layer, streams
    equal to (b)'s up to reference near-ties within ``band``.
    (d) ``start_api_server`` over (b)'s engine: ``/v1/models`` lists the
    two adapters; a chat request whose ``model`` names adapter 1 returns
    the stream the scheduler gives the same request directly.
    (e) ``apex_tpu_torch.examples.generate.main(["--beams", "4"])``."""
    from apex_tpu_torch.examples import generate as gen_example
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import (
        Engine,
        EngineConfig,
        Request,
        Scheduler,
        SpecGateConfig,
    )
    from apex_tpu_torch.serving.api import (
        ByteTokenizer,
        render_chat_prompt,
        start_api_server,
    )

    L, V = cfg.num_layers, cfg.vocab_size
    out = {}
    p = gpt.cast_params(cfg, params)

    # (a) beam search
    t = time.perf_counter()
    prompts = torch.as_tensor(np.random.default_rng(38).integers(
        0, V, (2, BEAM_PROMPT)), device="cuda")
    greedy = gpt.generate(cfg, p, prompts, BEAM_NEW)
    s1, _ = gpt.beam_search(cfg, p, prompts, BEAM_NEW, num_beams=1)
    check(torch.equal(s1[:, 0], greedy),
          f"beam (a): num_beams=1 {s1[:, 0].tolist()} != greedy "
          f"{greedy.tolist()}")
    torch.cuda.synchronize()
    reset_launch_counts()
    seqs, scores = gpt.beam_search(cfg, p, prompts, BEAM_NEW,
                                   num_beams=BEAMS)
    torch.cuda.synchronize()
    beam_counts = launch_counts()
    check(beam_counts["flash_attention_bsh"] == L
          and beam_counts["decode_attention_write"] == L * (BEAM_NEW - 1),
          f"beam (a): flash_attention_bsh {beam_counts['flash_attention_bsh']}"
          f", decode_attention_write {beam_counts['decode_attention_write']}"
          f", expected {L} and {L} x {BEAM_NEW - 1} steps")
    check_decode_step_kernels("beam (a)", beam_counts,
                              ("decode_attention_write",), BEAM_NEW - 1, L)
    check_tc("beam (a)", beam_counts, "flash_attention_bsh")
    sc = scores.float().cpu()
    check(bool(torch.isfinite(sc).all()) and bool((sc[:, 1:]
                                                   <= sc[:, :-1]).all()),
          f"beam (a): scores not finite and sorted: {sc.tolist()}")
    worst = 0.0
    for i in range(2):
        for j in range(BEAMS):
            tf = _tf_logprobs(cfg, params, prompts[i].tolist(),
                              seqs[i, j].tolist())
            worst = max(worst, abs(float(tf.sum()) - float(sc[i, j])))
    check(worst <= BEAM_NEW * band,
          f"beam (a): a score is {worst} off its teacher-forced total "
          f"(bound {BEAM_NEW} x {band})")
    # an eos that fires: the best beam's third token
    eos = int(seqs[0, 0, 2])
    es, esc = gpt.beam_search(cfg, p, prompts, BEAM_NEW, num_beams=BEAMS,
                              eos_token_id=eos, pad_token_id=0)
    frozen, worst_frozen = 0, 0.0
    for i in range(2):
        for j in range(BEAMS):
            row = es[i, j].tolist()
            if eos not in row[:-1]:
                continue
            at = row.index(eos)
            frozen += 1
            check(all(x == 0 for x in row[at + 1:]),
                  f"beam (a): a frozen beam emitted {row[at + 1:]} after "
                  f"its eos")
            tf = _tf_logprobs(cfg, params, prompts[i].tolist(), row[:at + 1])
            worst_frozen = max(worst_frozen,
                               abs(float(tf.sum()) - float(esc[i, j])))
            check(worst_frozen <= (at + 1) * band,
                  f"beam (a): a frozen beam's score {float(esc[i, j])} "
                  f"moved from its sum to the eos {float(tf.sum())}")
    check(frozen > 0, f"beam (a): eos {eos} froze no beam")
    n32, ms32 = _beam_launches(cfg, p, prompts, BEAM_NEW)
    n2, ms2 = _beam_launches(cfg, p, prompts, 2)
    steps = BEAM_NEW - 2
    cache = gpt.init_cache(cfg, p, 2 * BEAMS, max_len=BEAM_PROMPT + BEAM_NEW)
    gather = torch.arange(2 * BEAMS, device="cuda").flip(0)
    reorder = lambda: gpt._cache_map(lambda c: c.index_select(2, gather),
                                     cache)
    reorder_launches = _api_launches(reorder)
    reorder_ms = time_ms(reorder)
    del cache
    out["beam"] = dict(
        max_score_vs_teacher_forced=worst, frozen_beams=frozen,
        max_frozen_score_vs_sum_to_eos=worst_frozen,
        launches_per_beam_step=(n32 - n2) / steps,
        host_ms_per_beam_step=(statistics.median(ms32)
                               - statistics.median(ms2)) / steps,
        reorder_launches_per_step=reorder_launches,
        reorder_share_of_launches=(reorder_launches * steps / (n32 - n2)
                                   if n32 > n2 else None),
        reorder_ms=reorder_ms, launches_32=n32, launches_2=n2,
        ms_32=ms32, ms_2=ms2, beam_launches={
            k: beam_counts[k] for k in ("flash_attention_bsh",
                                        "decode_attention_write")},
        phase_s=time.perf_counter() - t)
    log(f"beam (a) ({card}): " + json.dumps(out["beam"]))

    # (b) multi-LoRA through Scheduler over Engine
    t = time.perf_counter()
    reqs = lora_trace(V)
    engine = Engine(cfg, params, EngineConfig(**LORA_GEOM, **LORA_POOL))
    ids = [engine.register_adapter(seed=s) for s in LORA_SEEDS]
    check(ids == [1, 2], f"lora (b): adapter ids {ids}")
    sched, wall, lora_counts, delta, mixed = serve_counted(
        engine, reqs, max_admit_batch=1)
    check_decode_step_kernels("lora (b)", lora_counts,
                              ("decode_attention_write",),
                              delta["decode_steps_taken"], L)
    check_prefills("lora (b)", lora_counts, delta, L)
    plain_engine = Engine(cfg, params, EngineConfig(**LORA_GEOM))
    _, _, _, _, base = serve_counted(
        plain_engine, lora_trace(V, adapters=False), max_admit_batch=1)
    del plain_engine
    drift = [r.request_id for r in reqs
             if r.adapter == 0 and mixed[r.request_id] != base[r.request_id]]
    check(not drift, f"lora (b): base rows differ from the pool-less "
          f"engine's: {drift}")
    moved = [r.request_id for r in reqs
             if r.adapter and mixed[r.request_id] != base[r.request_id]]
    check(moved, "lora (b): no adapter stream differs from its base stream")
    for a in (1, 2):
        mine = [r for r in reqs if r.adapter == a]
        _, _, _, _, alone = serve_counted(engine, mine, max_admit_batch=1)
        drift = [r.request_id for r in mine
                 if alone[r.request_id] != mixed[r.request_id]]
        check(not drift, f"lora (b): adapter {a}'s requests alone differ "
              f"from the mixed run: {drift}")
    merged = {0: params}
    want = {}
    for a, s in zip(ids, LORA_SEEDS):
        merged[a] = gpt.merge_lora(cfg, params, gpt.init_lora_weights(
            cfg, LORA_POOL["adapter_rank"], s), LORA_POOL["adapter_alpha"])
        mp = gpt.cast_params(cfg, merged[a])
        mine = [r for r in reqs if r.adapter == a]
        for n in sorted({len(r.prompt) for r in mine}):
            group = [r for r in mine if len(r.prompt) == n]
            outs = gpt.generate(cfg, mp, torch.as_tensor(
                [r.prompt for r in group], device="cuda"), LORA_NEW).tolist()
            want.update({r.request_id: o for r, o in zip(group, outs)})
        del mp
    adapter_reqs = [r for r in reqs if r.adapter]
    gaps = _gaps_by_adapter(cfg, merged, adapter_reqs, mixed, want)
    check(all(g <= band for _, _, _, g in gaps),
          f"lora (b): adapter streams part from the merged generate past "
          f"the band {band}: {gaps}")
    out["lora"] = dict(
        wall_s=wall, decode_steps=delta["decode_steps_taken"],
        admit_groups=delta["admit_groups"],
        adapter_bytes=engine.adapter_bytes(),
        adapter_id_uploads=engine.adapter_id_uploads,
        adapter_streams_moved=len(moved), vs_merged=dict(
            identical=len(adapter_reqs) - len(gaps),
            first_divergence_gaps=gaps),
        launches={k: lora_counts[k] for k in ("flash_attention_bsh",
                                              "decode_attention_write")})
    log(f"lora (b) ({card}): " + json.dumps(out["lora"]))

    # (b) a decode step with base rows only and with adapter rows, in turns
    turns = []
    for side in ("base", "lora", "lora", "base"):
        window = lora_trace(V, n=SLOTS, adapters=side == "lora")
        for r in window:
            r.max_tokens = 40
        prof = phase_profile(cfg, engine, chunks=8, reqs=window,
                             what=f"lora (b) {side}")
        check(prof is not None, "lora (b): the profiler saw no kernel")
        turns.append(dict(side=side, **{k: prof[k] for k in (
            "decode_steps", "host_ms_per_decode_step",
            "launches_per_decode_step", "device_idle_share")}))
    if prof5 is not None:
        base_turns = [x["launches_per_decode_step"] for x in turns
                      if x["side"] == "base"]
        check(all(x == prof5["launches_per_decode_step"]
                  for x in base_turns),
              f"lora (b): a base-only decode step on the pool engine "
              f"launched {base_turns}, phase 6 "
              f"{prof5['launches_per_decode_step']}")
    out["decode_step"] = dict(
        phase6_launches=None if prof5 is None
        else prof5["launches_per_decode_step"], turns=turns)
    log(f"lora (b) decode step ({card}): " + json.dumps(out["decode_step"]))
    out["lora"]["phase_s"] = time.perf_counter() - t

    # (c) paged + speculative with adapters (0, 1, 2)
    t = time.perf_counter()
    spec_reqs = reqs[:LORA_SPEC_REQS]
    spec_engine = Engine(cfg, params, EngineConfig(
        **LORA_GEOM, **LORA_POOL, page_size=PAGE, spec_k=SPEC_K))
    for s in LORA_SEEDS:
        spec_engine.register_adapter(seed=s)
    _, _, spec_counts, sdelta, spec = serve_counted(
        spec_engine, spec_reqs, max_admit_batch=1,
        spec_gate=SpecGateConfig(probe_every=2))
    steps, waves = sdelta["decode_steps_taken"], sdelta["spec_waves_taken"]
    check(spec_counts["paged_attention_write"] == L * steps > 0
          and spec_counts["paged_verify_attention"] == L * waves > 0
          and spec_counts["decode_attention_write"] == 0
          and spec_counts["decode_verify_attention"] == 0
          and spec_counts["paged_write_columns"] == 0,
          f"lora (c): paged_attention_write "
          f"{spec_counts['paged_attention_write']} (expected {L} x {steps}"
          f" steps), paged_verify_attention "
          f"{spec_counts['paged_verify_attention']} (expected {L} x "
          f"{waves} waves), contiguous decode "
          f"{spec_counts['decode_attention_write']}, verify "
          f"{spec_counts['decode_verify_attention']}")
    del spec_engine
    sgaps = _gaps_by_adapter(cfg, merged, spec_reqs, spec, mixed)
    check(all(g <= band for _, _, _, g in sgaps),
          f"lora (c): paged spec streams part from the contiguous plain "
          f"ones past the band {band}: {sgaps}")
    out["spec"] = dict(
        decode_steps=steps, waves=waves,
        identical=len(spec_reqs) - len(sgaps), first_divergence_gaps=sgaps,
        launches={k: spec_counts[k] for k in ("paged_attention_write",
                                              "paged_verify_attention")},
        phase_s=time.perf_counter() - t)
    log(f"lora (c) ({card}): " + json.dumps(out["spec"]))
    del merged

    # (d) the front end: adapter models and routing by name
    t = time.perf_counter()
    tok = ByteTokenizer(V)
    msgs = _chat_messages(38)
    api_sched = Scheduler(engine, max_admit_batch=1)
    server = start_api_server(api_sched, port=0)
    try:
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=600)
        conn.request("GET", "/v1/models")
        models = json.loads(conn.getresponse().read())["data"]
        conn.close()
        status, _, d = _http(server.port, "/v1/chat/completions", {
            "model": "adapter-seed-7", "messages": msgs,
            "max_tokens": API_CHAT_NEW, "return_token_ids": True})
    finally:
        server.stop()
    listed = [(m["id"], m.get("adapter")) for m in models]
    check(listed == [(server.model, None), ("adapter-seed-7", 1),
                     ("adapter-seed-9", 2)],
          f"lora (d): /v1/models lists {listed}")
    check(status == 200, f"lora (d): status {status}: {d}")
    direct = Scheduler(engine, max_admit_batch=1)
    direct.submit(Request("direct", tok.encode(render_chat_prompt(msgs)),
                          max_tokens=API_CHAT_NEW, adapter=1))
    direct.run_until_idle()
    got_d = d["choices"][0]["token_ids"]
    check(got_d == direct.completions["direct"].tokens,
          f"lora (d): the adapter-seed-7 chat stream {got_d} != the "
          f"scheduler's {direct.completions['direct'].tokens}")
    out["api"] = dict(models=listed, tokens=len(got_d),
                      phase_s=time.perf_counter() - t)
    log(f"lora (d) ({card}): " + json.dumps(out["api"]))
    del engine

    # (e) the example
    t = time.perf_counter()
    ex = gen_example.main(["--beams", "4"])
    check(len(ex) == 2 and all(len(x) == 16 for x in ex),
          f"beam (e): the example returned {ex}")
    out["example_s"] = time.perf_counter() - t
    log(f"beam (e) ({card}): examples.generate --beams 4 -> {ex}")
    return beam_counts, lora_counts, spec_counts, out


# ---------------------------------------------------------------------------
# phase 39: the host-swap tier — park/resume, preemption, adapter paging
# ---------------------------------------------------------------------------

#: serve()'s paged geometry with the host tier under the pool
HS_GEOM = dict(slots=SLOTS, max_prompt_len=64, max_seq_len=HORIZON,
               page_size=PAGE, host_swap=True)
HS_REQS, HS_NEW = 16, 48
#: (c): the sink and three worst-case conversations for 8 slots
HS_STARVED_PAGES = 1 + 3 * MAX_PAGES
#: (d): a host tier of one worst-case conversation
HS_TIER_PAGES = MAX_PAGES
HS_TENANTS = ("t0", "t1", "t2")
#: (e): 4 adapters by seed, 2 usable rows against an all-resident pool
HS_ADAPTERS = (7, 9, 11, 13)
HS_LORA = dict(adapter_rank=8, adapter_alpha=16.0)
#: the spec runs' gate: one plain chunk, then only verify waves, so a
#: paused run and its uninterrupted twin run the same chunk kinds
HS_SPEC_GATE = dict(min_probe_chunks=10 ** 9)
#: the (b) and (f) runs' decode-step kernels (rows 14 + 18, 13 + 17)
HS_QUANT_STEP = ("paged_write_column_quant", "paged_attention_quant")
HS_ROWS = ("flash_attention_bsh", "paged_attention_write",
           "paged_verify_attention", "paged_write_column_quant",
           "paged_attention_quant", "paged_write_columns_quant")


def hs_trace(vocab: int, tenants=(), adapters: int = 0):
    """bench's trace shape, 16 requests of HS_NEW tokens from seed 3900
    (odd ones sampled with their own seed), ``tenants`` round-robin,
    request ``i`` on adapter ``i % (adapters + 1)``."""
    reqs = bench_trace(vocab, n=HS_REQS, max_tokens=HS_NEW, seed0=3900)
    for i, r in enumerate(reqs):
        if tenants:
            r.tenant = tenants[i % len(tenants)]
        if adapters:
            r.adapter = i % (adapters + 1)
    return reqs


def serve_hs(engine, reqs, *, pause: bool = False, full: bool = True,
             **sched_kw):
    """Serve ``reqs`` (all at t=0) through a new ``Scheduler``, the launch
    counts zeroed just before and read just after; with ``pause``, two
    ticks in every active conversation parks (all SLOTS of them when
    ``full``) and, two ticks later, each is resumed. Returns the scheduler, the counts, the engine counters'
    deltas, the streams, the streamed tokens of each request (its
    events, concatenated) and the paused ids that came back by
    recompute (those the resume put into the queue)."""
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Scheduler

    sched = Scheduler(engine, **sched_kw)
    before = {k: getattr(engine, k) for k in ENGINE_COUNTERS}
    torch.cuda.synchronize()
    reset_launch_counts()
    for r in reqs:
        sched.submit(r)
    recomputed = set()
    if pause:
        for _ in range(2):
            sched.step()
        paused = [rid for rid in sorted(a.request.request_id
                                        for a in sched.active.values())
                  if sched.pause(rid)]
        check(len(paused) == SLOTS if full else len(paused) > 0,
              f"hostswap: {len(paused)} conversations parked")
        for _ in range(2):
            sched.step()
        for rid in paused:
            check(sched.resume(rid), f"hostswap: {rid} not parked")
        recomputed = {r.request_id for r in sched.queue} & set(paused)
    sched.run_until_idle()
    torch.cuda.synchronize()
    counts = launch_counts()
    delta = {k: getattr(engine, k) - v for k, v in before.items()}
    streamed = {}
    for e in sched.events:
        if e.token is not None:
            streamed.setdefault(e.request_id, []).append(e.token)
    for r in reqs:
        c = sched.completions.get(r.request_id)
        check(c is not None and c.finish_reason in ("length", "eos")
              and (len(c.tokens) == r.max_tokens
                   or c.finish_reason == "eos"),
              f"hostswap: {r.request_id} finished "
              f"{None if c is None else (c.finish_reason, len(c.tokens))}")
    return (sched, counts, delta,
            {k: c.tokens for k, c in sched.completions.items()}, streamed,
            recomputed)


def _hs_kernels(what, counts, delta, L, quant=False):
    """Row 5 on every layer of every admission group (tensor cores); the
    paged decode step (rows 13 + 17 fused, or int8's 14 + 18) on every
    layer of every decode step; the paged verify (15v, or int8's row 16)
    on every layer of every wave; no contiguous decode kernel."""
    check_prefills(what, counts, delta, L)
    steps, waves = delta["decode_steps_taken"], delta["spec_waves_taken"]
    on = HS_QUANT_STEP if quant else ("paged_attention_write",)
    check_decode_step_kernels(what, counts, on, steps, L)
    verify = "paged_write_columns_quant" if quant else \
        "paged_verify_attention"
    check(counts[verify] == L * waves
          and counts["decode_verify_attention"] == 0,
          f"{what}: {verify} launched {counts[verify]} times, expected "
          f"{L} x {waves} waves")


def _hs_hold(cfg, params, band, what, reqs, got, want, exact=()):
    """``got`` against ``want``: the requests of ``exact`` bit for bit,
    the others identical or parting first where the reference forward's
    top-2 gap is within ``band`` (returned, and counted in the log)."""
    gaps = _drift_gaps(cfg, params, reqs, got, want)
    bad = [g for g in gaps if g[0] in exact or g[2] > band]
    check(not bad, f"{what}: streams part from the uninterrupted run "
          f"(swap-resumed ones must not; others only within the band "
          f"{band}): {bad}")
    return gaps


def _hs_events(cfg, params, band, what, reqs, got, streamed):
    """Each request's streamed tokens against its completion's: equal, or
    (a replay that re-derived another token than the one streamed) parting
    first where the reference forward's top-2 gap along the streamed
    stream is within ``band``. Returns the partings."""
    out = []
    for r in reqs:
        ev, comp = streamed.get(r.request_id, []), got[r.request_id]
        if ev == comp:
            continue
        k = next((i for i, (x, y) in enumerate(zip(ev, comp)) if x != y),
                 min(len(ev), len(comp)))
        g = (_first_gap(cfg, params, r, ev, k,
                        comp[k] if k < len(comp) else None)
             if k < len(ev) else float("inf"))
        out.append((r.request_id, k, g))
    check(all(g <= band for _, _, g in out),
          f"{what}: streamed tokens differ from the completions past the "
          f"band {band}: {out}")
    return out


def _page_bytes(engine) -> int:
    return engine.cache_bytes() // engine.describe()["num_pages"]


def _swap_timing(engine, vocab: int, reps: int = 3):
    """Park and resume every slot of ``engine`` (8 conversations of a
    64-token prompt and budget, 16 private pages each) ``reps`` times:
    host ms a page each way (the host synchronised around each sweep),
    against a plain pinned ``copy_`` of the same bytes each way (the
    card's own pinned-copy rate, the swap's bound)."""
    from apex_tpu_torch.serving.engine import Admission

    rng = np.random.default_rng(39)
    engine.admit_many([Admission(
        slot=s, prompt=rng.integers(0, vocab, 64).tolist(), max_tokens=64)
        for s in range(SLOTS)])
    engine.step()
    pages = sum(engine.slot_page_count(s) for s in range(SLOTS))
    out_ms, in_ms = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for s in range(SLOTS):
            engine.park_slot(s, f"t{s}")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for s in range(SLOTS):
            engine.resume_slot(s, f"t{s}")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out_ms.append((t1 - t0) * 1e3 / pages)
        in_ms.append((t2 - t1) * 1e3 / pages)
    for s in range(SLOTS):
        engine.retire(s)
        engine.free_slot(s)
    nbytes = pages * _page_bytes(engine)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    d2h, h2d = [], []
    for _ in range(5):
        for side, fn in ((d2h, lambda: host.copy_(dev)),
                         (h2d, lambda: dev.copy_(host))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            side.append((time.perf_counter() - t0) * 1e3 / pages)
    del dev, host
    b_out, b_in = min(d2h), min(h2d)
    return dict(
        pages=pages, bytes_per_page=_page_bytes(engine),
        swap_out_ms_per_page=statistics.median(out_ms),
        swap_in_ms_per_page=statistics.median(in_ms),
        pinned_d2h_ms_per_page=b_out, pinned_h2d_ms_per_page=b_in,
        pinned_d2h_gb_s=_page_bytes(engine) / b_out / 1e6,
        pinned_h2d_gb_s=_page_bytes(engine) / b_in / 1e6,
        swap_out_over_bound=statistics.median(out_ms) / b_out,
        swap_in_over_bound=statistics.median(in_ms) / b_in,
        out_ms=out_ms, in_ms=in_ms)


def phase_hostswap(cfg, params, band: float, card: str, prof5):
    """Phase 39: the host-swap tier on the serving model (serve()'s
    geometry, pages of 8, ``host_swap=True``; hs_trace's 16 requests of
    48 tokens, half seeded-sampled). ``prof5`` is phase 6's profile.
    Returns the launch counts of every run together, and the numbers;
    each line of numbers names ``card``.

    (a) under ``swap``, ``recompute`` and ``auto``, on one engine each:
    the trace uninterrupted, then paused (every active conversation parks
    two ticks in, and resumes two ticks later): swap-resumed streams bit
    for bit the uninterrupted ones, the re-derived (recompute) and the
    never-parked ones identical or parting only at a near-tie within
    ``band`` (counted); each request's streamed tokens equal its
    completion's (or part at such a tie, counted).
    (b) int8, ``spec_k=3`` (the gate pinned to verify waves), ``swap``:
    the parked streams bit for bit, the others (admitted in other groups:
    waves finish requests unevenly) up to near-ties; rows 14 + 18 and 16
    on every layer.
    (c) a pool of HS_STARVED_PAGES pages, three tenants,
    ``preempt=True``: preemptions, every finish natural, streams against
    (a)'s uninterrupted ``swap`` run up to near-ties, events == streams.
    (d) bf16 ``spec_k=3`` (the pinned gate), a host tier of HS_TIER_PAGES
    pages, ``swap``: capacity drops and recompute resumes; every stream
    up to near-ties (a replay's plain chunks carry the whole batch);
    row 15v on every layer of every wave.
    (e) ``adapter_slots=3`` (two usable rows) with the adapters of
    HS_ADAPTERS registered by seed (rank 8), paused under ``swap``,
    against a pool of 5 rows serving the same trace: streams equal up to
    near-ties over the merged weights; spills, page-ins and adapter
    waits counted.
    (f) the bytes a parked page (bf16 and int8 against the geometry), the
    swap's host ms a page each way against a pinned ``copy_`` of the same
    bytes (on (a)'s ``swap`` engine, three more sweeps of 8 parks and 8
    resumes), then phase 6's window (8 chunks, 8 requests of 12 tokens)
    on that churned engine and on a fresh one: their launches a decode
    step equal (and phase 6's, the contiguous engine's, beside)."""
    import dataclasses

    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import Engine, EngineConfig, SpecGateConfig

    L, V = cfg.num_layers, cfg.vocab_size
    out, total = {}, {k: 0 for k in HS_ROWS}

    def add(counts):
        for k in HS_ROWS:
            total[k] += counts[k]

    # (a) pause / resume under each policy
    t = time.perf_counter()
    base_swap, churned, out["a"] = None, None, {}
    for policy in ("swap", "recompute", "auto"):
        engine = Engine(cfg, params, EngineConfig(**HS_GEOM,
                                                  resume_policy=policy))
        reqs = hs_trace(V)
        _, c0, d0, want, ev0, _ = serve_hs(engine, reqs)
        _hs_kernels(f"hostswap (a) {policy} base", c0, d0, L)
        check(ev0 == want, f"hostswap (a) {policy}: an uninterrupted "
              f"stream's events differ from its completion")
        sched, c1, d1, got, ev1, recomputed = serve_hs(
            engine, hs_trace(V), pause=True)
        _hs_kernels(f"hostswap (a) {policy}", c1, d1, L)
        add(c0)
        add(c1)
        s = sched.summary()
        paused = int(s["pauses"])
        check(paused == SLOTS and s["swap_resumes"] + s["recompute_resumes"]
              == paused and s["parked_conversations"] == 0
              and s["pages_in_use"] == 0 and s["pages_swapped"] == 0,
              f"hostswap (a) {policy}: summary {s}")
        check((policy != "swap" or s["swap_resumes"] == paused)
              and (policy != "recompute" or s["recompute_resumes"] == paused),
              f"hostswap (a) {policy}: {s['swap_resumes']} swap and "
              f"{s['recompute_resumes']} recompute resumes")
        swapped = {r.request_id for r in reqs[:SLOTS]} - recomputed
        gaps = _hs_hold(cfg, params, band, f"hostswap (a) {policy}", reqs,
                        got, want, exact=swapped)
        evg = _hs_events(cfg, params, band, f"hostswap (a) {policy}", reqs,
                         got, ev1)
        out["a"][policy] = dict(
            swap_resumes=s["swap_resumes"],
            recompute_resumes=s["recompute_resumes"],
            recomputed=sorted(recomputed), identical=len(reqs) - len(gaps),
            partings=gaps, event_partings=evg,
            decode_steps=d1["decode_steps_taken"],
            admit_groups=d1["admit_groups"])
        if policy == "swap":
            base_swap, churned = want, engine
        else:
            del engine
    out["a"]["phase_s"] = time.perf_counter() - t
    log(f"hostswap (a) ({card}): " + json.dumps(out["a"]))

    # (b) int8 + spec_k=3 under swap
    t = time.perf_counter()
    qcfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    engine = Engine(qcfg, params, EngineConfig(
        **HS_GEOM, resume_policy="swap", spec_k=SPEC_K))
    gate = SpecGateConfig(**HS_SPEC_GATE)
    _, c0, d0, want, _, _ = serve_hs(engine, hs_trace(V), spec_gate=gate)
    sched, c1, d1, got, ev1, _ = serve_hs(engine, hs_trace(V), pause=True,
                                          spec_gate=gate)
    for what, c, d in (("base", c0, d0), ("paused", c1, d1)):
        _hs_kernels(f"hostswap (b) {what}", c, d, L, quant=True)
        check(d["spec_waves_taken"] > 0, f"hostswap (b) {what}: no wave")
        add(c)
    s = sched.summary()
    check(s["swap_resumes"] == SLOTS, f"hostswap (b): {s['swap_resumes']} "
          f"swap resumes")
    # verify waves emit 1..4 tokens, so the second wave of requests
    # admits as slots free, in other groups than in the paused run: only
    # the parked ones are held bit for bit
    reqs = hs_trace(V)
    gaps = _hs_hold(cfg, params, band, "hostswap (b)", reqs, got, want,
                    exact={r.request_id for r in reqs[:SLOTS]})
    evg = _hs_events(cfg, params, band, "hostswap (b)", reqs, got, ev1)
    out["b"] = dict(swap_resumes=s["swap_resumes"],
                    identical=len(reqs) - len(gaps), partings=gaps,
                    event_partings=evg, waves=d1["spec_waves_taken"],
                    decode_steps=d1["decode_steps_taken"],
                    page_bytes=_page_bytes(engine),
                    phase_s=time.perf_counter() - t)
    del engine
    log(f"hostswap (b) ({card}): " + json.dumps(out["b"]))

    # (c) a starved pool: preemption
    t = time.perf_counter()
    engine = Engine(cfg, params, EngineConfig(
        **HS_GEOM, resume_policy="swap", num_pages=HS_STARVED_PAGES))
    reqs = hs_trace(V, tenants=HS_TENANTS)
    sched, c, d, got, ev, _ = serve_hs(engine, reqs, preempt=True)
    _hs_kernels("hostswap (c)", c, d, L)
    add(c)
    s = sched.summary()
    check(s["preemptions"] >= 1, f"hostswap (c): no preemption ({s})")
    gaps = _hs_hold(cfg, params, band, "hostswap (c)", reqs, got, base_swap)
    evg = _hs_events(cfg, params, band, "hostswap (c)", reqs, got, ev)
    out["c"] = dict(preemptions=s["preemptions"],
                    pages_exhausted_waits=s["pages_exhausted_waits"],
                    identical=len(reqs) - len(gaps), partings=gaps,
                    event_partings=evg, tenants=sched.tenant_summary(),
                    phase_s=time.perf_counter() - t)
    del engine
    log(f"hostswap (c) ({card}): " + json.dumps(out["c"]))

    # (d) a bounded host tier under spec: capacity drops
    t = time.perf_counter()
    engine = Engine(cfg, params, EngineConfig(
        **HS_GEOM, resume_policy="swap", spec_k=SPEC_K,
        host_swap_pages=HS_TIER_PAGES))
    reqs = hs_trace(V)
    _, c0, d0, want, _, _ = serve_hs(engine, reqs, spec_gate=gate)
    sched, c1, d1, got, ev1, recomputed = serve_hs(
        engine, hs_trace(V), pause=True, spec_gate=gate)
    for what, c, d in (("base", c0, d0), ("paused", c1, d1)):
        _hs_kernels(f"hostswap (d) {what}", c, d, L)
        check(d["spec_waves_taken"] > 0, f"hostswap (d) {what}: no wave")
        add(c)
    s = sched.summary()
    check(s["swap_capacity_drops"] >= 1 and s["recompute_resumes"] >= 1
          and s["swap_resumes"] >= 1,
          f"hostswap (d): drops {s['swap_capacity_drops']}, swap "
          f"{s['swap_resumes']}, recompute {s['recompute_resumes']}")
    # a replay runs plain chunks for the whole batch (as in JAX), so the
    # swap-resumed streams here also meet plain steps where their
    # uninterrupted twins had verify waves: every stream is held to the
    # near-tie rule
    gaps = _hs_hold(cfg, params, band, "hostswap (d)", reqs, got, want)
    evg = _hs_events(cfg, params, band, "hostswap (d)", reqs, got, ev1)
    out["d"] = dict(capacity_drops=s["swap_capacity_drops"],
                    swap_resumes=s["swap_resumes"],
                    recompute_resumes=s["recompute_resumes"],
                    recomputed=sorted(recomputed),
                    waves=d1["spec_waves_taken"],
                    identical=len(reqs) - len(gaps), partings=gaps,
                    event_partings=evg, phase_s=time.perf_counter() - t)
    del engine
    log(f"hostswap (d) ({card}): " + json.dumps(out["d"]))

    # (e) adapter paging against an all-resident pool
    t = time.perf_counter()
    n_ad = len(HS_ADAPTERS)
    runs = {}
    for rows in (3, n_ad + 1):
        engine = Engine(cfg, params, EngineConfig(
            **HS_GEOM, resume_policy="swap", adapter_slots=rows,
            **HS_LORA))
        ids = [engine.register_adapter(seed=s) for s in HS_ADAPTERS]
        check(ids == list(range(1, n_ad + 1)),
              f"hostswap (e): adapter ids {ids}")
        reqs = hs_trace(V, adapters=n_ad)
        sched, c, d, got, ev, _ = serve_hs(engine, reqs, pause=rows == 3,
                                           full=False)
        _hs_kernels(f"hostswap (e) {rows} rows", c, d, L)
        check(ev == got, f"hostswap (e) {rows} rows: events differ from "
              f"the completions")
        add(c)
        runs[rows] = (got, sched.summary(), engine.adapter_paging_stats())
        del engine
    (got, s, stats), (want, _, _) = runs[3], runs[n_ad + 1]
    check(stats["registered"] == n_ad and stats["rows"] == 2
          and stats["spills_total"] >= 1 and stats["pageins_total"] > 2,
          f"hostswap (e): paging stats {stats}")
    gaps = []
    if got != want:
        merged = {0: params}
        for a, seed in enumerate(HS_ADAPTERS, 1):
            if any(r.adapter == a and got[r.request_id] != want[r.request_id]
                   for r in reqs):
                merged[a] = gpt.merge_lora(cfg, params, gpt.init_lora_weights(
                    cfg, HS_LORA["adapter_rank"], seed),
                    HS_LORA["adapter_alpha"])
        gaps = _gaps_by_adapter(cfg, merged, [
            r for r in reqs if r.adapter in merged], got, want)
        del merged
    check(all(g <= band for _, _, _, g in gaps),
          f"hostswap (e): paged-adapter streams part from the resident "
          f"pool's past the band {band}: {gaps}")
    out["e"] = dict(paging=stats, adapter_waits=s["adapter_waits"],
                    swap_resumes=s["swap_resumes"],
                    identical=len(reqs) - len(gaps), partings=gaps,
                    phase_s=time.perf_counter() - t)
    log(f"hostswap (e) ({card}): " + json.dumps(out["e"]))

    # (f) bytes a page, the swap against the pinned-copy bound, and a
    # decode step after the churn
    t = time.perf_counter()
    d = cfg.head_dim
    item = torch.empty((), dtype=cfg.compute_dtype).element_size()
    want_bf16 = L * 2 * cfg.num_heads * PAGE * d * item
    want_int8 = L * 2 * cfg.num_heads * PAGE * (d + 4)
    check(_page_bytes(churned) == want_bf16
          and out["b"]["page_bytes"] == want_int8,
          f"hostswap (f): bytes a page {_page_bytes(churned)} / "
          f"{out['b']['page_bytes']}, expected {want_bf16} / {want_int8}")
    swap = _swap_timing(churned, V)
    fresh = Engine(cfg, params, EngineConfig(**HS_GEOM))
    turns = []
    for side, engine in (("churned", churned), ("fresh", fresh)):
        prof = phase_profile(cfg, engine, chunks=8, reqs=bench_trace(
            V, n=SLOTS, max_tokens=12, seed0=5000),
            what=f"hostswap (f) {side}")
        check(prof is not None, "hostswap (f): the profiler saw no kernel")
        turns.append(dict(side=side, **{k: prof[k] for k in (
            "decode_steps", "host_ms_per_decode_step",
            "launches_per_decode_step", "device_idle_share")}))
    launches = {x["launches_per_decode_step"] for x in turns}
    check(len(launches) == 1, f"hostswap (f): launches a decode step "
          f"differ after the churn: {turns}")
    out["f"] = dict(
        bytes_per_page_bf16=want_bf16, bytes_per_page_int8=want_int8,
        swap=swap, decode_step=turns,
        phase6_launches=None if prof5 is None
        else prof5["launches_per_decode_step"],
        phase_s=time.perf_counter() - t)
    del fresh, churned
    log(f"hostswap (f) ({card}): " + json.dumps(out["f"]))
    return total, out


# ---------------------------------------------------------------------------
# phase 40: serving telemetry and the self-tuning scheduler
# ---------------------------------------------------------------------------

#: (a): the contiguous engine's ladders (bench's decode_chunk sweep) under
#: the tuner, the SLO objectives, and at most this many back-to-back
#: traces until each tuned knob has ended a probe window
TL_GEOM = dict(slots=SLOTS, max_prompt_len=64, max_seq_len=HORIZON)
TL_CHUNKS = (1, 2, 4, 8)
TL_BASE_CHUNK = 4
TL_SLO = "p99:ttft:1.0,p95:e2e:10.0"
TL_MAX_TRACES = 4
#: (b): the paged engine, the tuner owning spec_k, 16 requests of 48;
#: verify waves of a random model's repetitive greedy streams emit up to
#: 4 tokens, so the trace may run as few as 24 chunks: a probe every 8
#: incumbent chunks ends a window within it
TL_PAGED = dict(slots=SLOTS, max_prompt_len=64, max_seq_len=HORIZON,
                page_size=PAGE, spec_k=SPEC_K, spec_ks=(SPEC_K,))
TL_SPEC_TUNER = dict(spec_k=(0, SPEC_K), probe_every=8)
#: (c): windows a side, taken in turns (on, off, off, on, ...)
TL_WINDOWS = 4
#: the launch counts phase 40 reports, and the rows they are added to
TL_ROWS = ("flash_attention_bsh", "decode_attention_write",
           "paged_attention_write", "paged_verify_attention")


def _tl_sinks():
    """Every telemetry sink, fresh: a registry, a span recorder, a flight
    recorder, the SLO config and a metrics logger into the registry."""
    from apex_tpu_torch.profiler import MetricsLogger
    from apex_tpu_torch.telemetry import (FlightRecorder, Registry,
                                          SpanRecorder)
    from apex_tpu_torch.telemetry.slo import SLOConfig, parse_objective

    reg = Registry()
    return dict(registry=reg, spans=SpanRecorder(),
                recorder=FlightRecorder(),
                slo=SLOConfig(objectives=tuple(
                    parse_objective(p) for p in TL_SLO.split(","))),
                metrics=MetricsLogger(registry=reg, registry_prefix="tick_"))


def _tl_trace(vocab: int, k: int):
    """bench's trace (32 requests of 64 tokens), its ids marked with the
    run ``k`` so back-to-back runs can share a scheduler."""
    reqs = bench_trace(vocab)
    for r in reqs:
        r.request_id = f"k{k}-{r.request_id}"
    return reqs


def _tl_serve(sched, reqs, mid=None):
    """Submit ``reqs`` and step to idle, the launch counts zeroed just
    before and read just after; ``mid()`` runs once, ten ticks in.
    Returns the counts, the engine counters' deltas and the
    streams by the trace's own request ids."""
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts

    engine = sched.engine
    before = {k: getattr(engine, k) for k in ENGINE_COUNTERS}
    torch.cuda.synchronize()
    reset_launch_counts()
    for r in reqs:
        sched.submit(r)
    steps = 0
    while not sched.idle():
        sched.step()
        steps += 1
        if mid is not None and steps == 10:
            mid()
    torch.cuda.synchronize()
    counts = launch_counts()
    delta = {k: getattr(engine, k) - v for k, v in before.items()}
    streams = {}
    for r in reqs:
        c = sched.completions.get(r.request_id)
        check(c is not None and c.finish_reason in ("length", "eos")
              and (len(c.tokens) == r.max_tokens or c.finish_reason == "eos"),
              f"telemetry: {r.request_id} finished "
              f"{None if c is None else (c.finish_reason, len(c.tokens))}")
        streams[r.request_id.split("-", 1)[-1]] = c.tokens
    return counts, delta, streams


def _tl_get(url: str):
    """GET ``url``: (status, body text)."""
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read().decode("utf-8")


def _tl_scrape(url: str):
    from apex_tpu_torch.telemetry import parse_prometheus_text

    return parse_prometheus_text(_tl_get(url + "/metrics")[1])


def _tl_decisions(rec):
    return [e for e in rec.to_dicts(rec.events())
            if e["event"] in ("tuner_probe", "tuner_switch", "tuner_freeze")]


def phase_telemetry(cfg, params, band: float, card: str, prof5):
    """Phase 40: the telemetry layer and the tuner on the serving model.
    ``prof5`` is phase 6's profile. Returns the launch counts of every
    served run together, and the numbers; each line names ``card``.

    (a) the contiguous engine (serve()'s geometry, ``decode_chunk`` 4 on
    the ladder (1, 2, 4, 8)) under ``TunerConfig(decode_chunk=(1, 2, 4,
    8), pipeline_depth=(1, 2))`` with every sink on (registry, spans,
    flight recorder, ``slo``, a metrics logger) and ``MetricsServer`` on
    127.0.0.1:0: bench's trace back to back on one scheduler until each
    knob has ended a probe window (at most TL_MAX_TRACES); every stream
    equal to the same trace's at the fixed base point (chunk 4, depth 1,
    no tuner) or parting only at a near-tie within ``band`` (counted);
    the decisions printed; the server scraped mid-run and at the end, its
    completed requests and emitted tokens equal to ``summary()``'s and
    ``serving_tuner_switches_total`` to the recorded switches.
    (b) the paged engine, ``spec_k`` 3 on ``spec_ks=(3,)``, the tuner
    owning ``spec_k`` over (0, 3) (no payoff gate): 16 requests of 48
    tokens, every stream the plain engine's up to near-ties; rows 13 + 17
    on every layer of every decode step, 15v of every wave.
    (c) (a)'s engine at its rung 1, a decode step with every sink on
    against one with none, in turns (TL_WINDOWS windows each, phase 6's
    window): the launches a decode step equal on both sides and to phase
    6's (hard), the host ms and idle share printed.
    (d) the bundle ``dump_bundle`` wrote after (a)'s last trace (the
    requests of that trace, the events of all):
    ``replay_tuner`` and ``replay_slo`` reproduce every decision and
    alert, EWMAs and burn rates bit for bit (hard); ``replay_bundle``
    rebuilds the 355M on the card from it (seed 0) and replays the
    trace, each stream equal to its recording or parting at a near-tie
    (counted); ``render_report`` renders it.
    (e) ``start_api_server(..., registry=...)`` over (a)'s engine with an
    SLO monitor: one request, its counters, and ``/slo`` 200 with the
    scheduler's snapshot."""
    import tempfile

    from apex_tpu_torch.serving import Engine, EngineConfig, Scheduler
    from apex_tpu_torch.serving.api import start_api_server
    from apex_tpu_torch.serving.tuner import TunerConfig
    from apex_tpu_torch.telemetry import replay, start_metrics_server
    from apex_tpu_torch.telemetry.flightrec import read_bundle

    L, V = cfg.num_layers, cfg.vocab_size
    out, total = {}, {k: 0 for k in TL_ROWS}
    tmp = tempfile.mkdtemp(prefix="phase40-")

    def add(counts):
        for k in TL_ROWS:
            total[k] += counts[k]

    # (a) the contiguous engine under the tuner, every sink on
    t = time.perf_counter()
    reqs = bench_trace(V)
    engine = Engine(cfg, params, EngineConfig(
        **TL_GEOM, decode_chunk=TL_BASE_CHUNK, decode_chunks=TL_CHUNKS))
    c0, d0, base = _tl_serve(Scheduler(engine), _tl_trace(V, 0))
    check_prefills("telemetry (a) base", c0, d0, L)
    check_decode_step_kernels("telemetry (a) base", c0,
                              ("decode_attention_write",),
                              d0["decode_steps_taken"], L)
    add(c0)
    sinks = _tl_sinks()
    # the bundle keeps the last trace's requests (the replay's trace) and
    # every trace's events (the decisions and alerts)
    sched = Scheduler(engine, tuner=TunerConfig(
        decode_chunk=TL_CHUNKS, pipeline_depth=(1, 2)),
        bundle_dir=tmp, bundle_meta={"params": {"init_seed": 0}},
        request_log=len(reqs), **sinks)
    rec = sinks["recorder"]
    server = start_metrics_server(sinks["registry"], spans=sinks["spans"],
                                  recorder=rec, slo=sched.slo.status)
    mids, runs = [], []
    try:
        for k in range(1, TL_MAX_TRACES + 1):
            c1, d1, got = _tl_serve(
                sched, _tl_trace(V, k),
                mid=lambda: mids.append(_tl_scrape(server.url)))
            check_prefills(f"telemetry (a) tuned {k}", c1, d1, L)
            check_decode_step_kernels(f"telemetry (a) tuned {k}", c1,
                                      ("decode_attention_write",),
                                      d1["decode_steps_taken"], L)
            add(c1)
            gaps = _hs_hold(cfg, params, band, f"telemetry (a) tuned {k}",
                            reqs, got, base)
            ncols = sorted({e[3][1] for e in rec.events()
                            if e[2] == "dispatch"})
            runs.append(dict(identical=len(reqs) - len(gaps),
                             partings=gaps,
                             decode_steps=d1["decode_steps_taken"],
                             chunk_widths=ncols))
            ended = {e["knob"] for e in _tl_decisions(rec)
                     if e["event"] == "tuner_probe" and e["phase"] == "end"}
            if ended >= {"decode_chunk", "pipeline_depth"}:
                break
        check(ended >= {"decode_chunk", "pipeline_depth"},
              f"telemetry (a): probe windows ended for {sorted(ended)} "
              f"only, over {len(runs)} traces")
        final = _tl_scrape(server.url)
    finally:
        server.stop()
    bundle_path = sched.dump_bundle("phase40")
    s = sched.summary()
    decisions = _tl_decisions(rec)
    for e in decisions:
        log(f"telemetry (a) decision ({card}): " + json.dumps(
            {k: v for k, v in e.items() if k != "t"}, sort_keys=True))
    switches = sum(1 for e in decisions if e["event"] == "tuner_switch")
    finished = sum(final["serving_requests_finished_total"].values())
    tokens = final["serving_tokens_emitted_total"][()]
    scraped_switches = sum(final["serving_tuner_switches_total"].values())
    check(finished == s["requests_completed"]
          and tokens == s["tokens_emitted"],
          f"telemetry (e): the scrape's {finished} requests / {tokens} "
          f"tokens against summary()'s {s['requests_completed']} / "
          f"{s['tokens_emitted']}")
    check(scraped_switches == switches == s["tuner_switches"],
          f"telemetry (e): serving_tuner_switches_total "
          f"{scraped_switches} against {switches} recorded switches")
    check(bool(mids) and mids[0]["serving_tokens_emitted_total"][()]
          <= tokens, "telemetry (e): no mid-run scrape")
    check(s["slo_ttft_p99_ms"] > 0 and "predicted_ttft_s" in s,
          f"telemetry (a): the SLO keys of summary() {s}")
    out["a"] = dict(
        traces=len(runs), runs=runs, decisions=len(decisions),
        probes=s["tuner_probes"], switches=switches,
        incumbent={k: s[f"tuner_{k}"] for k in ("decode_chunk",
                                                "pipeline_depth")},
        slo={k: v for k, v in s.items() if k.startswith("slo_")},
        tokens_per_sec=s["tokens_per_sec"],
        flightrec=rec.summary(), phase_s=time.perf_counter() - t)
    out["e"] = dict(scrapes=len(mids) + 1, series=len(final),
                    finished=finished, tokens=tokens,
                    tuner_switches_total=scraped_switches)
    log(f"telemetry (a) ({card}): " + json.dumps(out["a"]))

    # (e) one request through the front end with a registry and an SLO
    # monitor on (a)'s engine
    api_sinks = _tl_sinks()
    api = start_api_server(Scheduler(engine, slo=api_sinks["slo"]),
                           port=0, registry=api_sinks["registry"])
    try:
        status, _, body = _http(api.port, "/v1/completions", {
            "prompt": list(range(1, 17)), "max_tokens": 8})
        slo_status, snap = _tl_get(api.url + "/slo")
        snap = json.loads(snap)
    finally:
        api.stop()
    text = api_sinks["registry"].to_prometheus_text()
    check(status == 200 and 1 <= body["usage"]["completion_tokens"] <= 8
          and slo_status == 200
          and snap["metrics"]["ttft"]["count"] == 1.0
          and 'api_requests_total{route="completions"} 1' in text
          and 'api_responses_total{route="completions",code="200"} 1'
          in text, f"telemetry (e): the front end answered {status}, "
          f"/slo {slo_status} {snap}")
    out["e"].update(api_status=status, slo_status=slo_status,
                    slo_objectives=sorted(snap["objectives"]))
    log(f"telemetry (e) ({card}): " + json.dumps(out["e"]))

    # (c) the cost of telemetry: a decode step with every sink on and
    # with none, in turns, on (a)'s engine at its rung 1
    t = time.perf_counter()
    turns = []
    for i in range(2 * TL_WINDOWS):
        on = i % 4 in (0, 3)
        prof = phase_profile(
            cfg, engine, chunks=8, chunk=1,
            reqs=bench_trace(V, n=SLOTS, max_tokens=12, seed0=5100 + i),
            sched_kw=_tl_sinks() if on else None,
            what=f"telemetry (c) {'on' if on else 'off'} {i}")
        check(prof is not None, "telemetry (c): the profiler saw no kernel")
        turns.append(dict(sinks=on, **{k: prof[k] for k in (
            "decode_steps", "host_ms_per_decode_step",
            "launches_per_decode_step", "device_idle_share")}))
    launches = {x["launches_per_decode_step"] for x in turns}
    want = None if prof5 is None else prof5["launches_per_decode_step"]
    check(len(launches) == 1 and (want is None or launches == {want}),
          f"telemetry (c): launches a decode step with and without the "
          f"sinks {sorted(launches)}, phase 6's {want}")
    side = {on: [x for x in turns if x["sinks"] == on] for on in (1, 0)}
    out["c"] = dict(
        launches_per_decode_step=launches.pop(), phase6_launches=want,
        host_ms_on=statistics.median(
            x["host_ms_per_decode_step"] for x in side[1]),
        host_ms_off=statistics.median(
            x["host_ms_per_decode_step"] for x in side[0]),
        idle_on=statistics.median(x["device_idle_share"] for x in side[1]),
        idle_off=statistics.median(x["device_idle_share"]
                                   for x in side[0]),
        turns=turns, phase_s=time.perf_counter() - t)
    log(f"telemetry (c) ({card}): " + json.dumps(out["c"]))
    del engine, sched

    # (d) the bundle: decisions and alerts bit for bit, the trace replayed
    # on a rebuilt engine, the report
    t = time.perf_counter()
    bundle = read_bundle(bundle_path)
    tn, sl = replay.replay_tuner(bundle), replay.replay_slo(bundle)
    check(tn is not None and tn["mismatches"] == []
          and tn["decisions_recorded"] == tn["decisions_replayed"] > 0,
          f"telemetry (d): replay_tuner {tn}")
    check(sl is not None and sl["mismatches"] == []
          and sl["evaluations"] > 0, f"telemetry (d): replay_slo {sl}")
    recorded = {r["request_id"].split("-", 1)[-1]: r["emitted"]
                for r in bundle["requests.jsonl"]}
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    rep = replay.replay_bundle(bundle_path, device="cuda", verbose=False)
    add(launch_counts())
    streams = {rid.split("-", 1)[-1]: toks
               for rid, toks in rep["streams"].items()}
    check(rep["replayed"] == len(reqs) and rep["skipped"] == []
          and rep["tuner"]["mismatches"] == []
          and rep["slo"]["mismatches"] == [],
          f"telemetry (d): replay_bundle {rep['replayed']} replayed, "
          f"skipped {rep['skipped']}")
    gaps = _hs_hold(cfg, params, band, "telemetry (d) replay", reqs,
                    streams, recorded)
    report = replay.render_report(bundle)
    check(report.startswith("post-mortem bundle: cause=phase40"),
          "telemetry (d): render_report")
    out["d"] = dict(decisions=tn["decisions_recorded"],
                    observations=tn["observations"],
                    slo_evaluations=sl["evaluations"],
                    slo_transitions=sl["transitions_recorded"],
                    replayed=rep["replayed"],
                    identical=len(reqs) - len(gaps), partings=gaps,
                    report_lines=len(report.splitlines()),
                    phase_s=time.perf_counter() - t)
    log(f"telemetry (d) ({card}): " + json.dumps(out["d"]))

    # (b) the paged engine with the tuner owning spec_k
    t = time.perf_counter()
    reqs = hs_trace(V)
    plain = Engine(cfg, params, EngineConfig(
        **{k: v for k, v in TL_PAGED.items()
           if k not in ("spec_k", "spec_ks")}))
    c0, d0, want = _tl_serve(Scheduler(plain), hs_trace(V))
    _hs_kernels("telemetry (b) plain", c0, d0, L)
    add(c0)
    del plain
    engine = Engine(cfg, params, EngineConfig(**TL_PAGED))
    sinks = _tl_sinks()
    sched = Scheduler(engine, tuner=TunerConfig(**TL_SPEC_TUNER), **sinks)
    check(sched._gate is None, "telemetry (b): a payoff gate beside the "
          "tuner")
    c1, d1, got = _tl_serve(sched, hs_trace(V))
    _hs_kernels("telemetry (b)", c1, d1, L)
    add(c1)
    check(d1["spec_waves_taken"] > 0, "telemetry (b): no verify wave")
    gaps = _hs_hold(cfg, params, band, "telemetry (b)", reqs, got, want)
    s = sched.summary()
    decisions = _tl_decisions(sinks["recorder"])
    for e in decisions:
        log(f"telemetry (b) decision ({card}): " + json.dumps(
            {k: v for k, v in e.items() if k != "t"}, sort_keys=True))
    check(any(e["event"] == "tuner_probe" and e["phase"] == "end"
              and e["knob"] == "spec_k" for e in decisions),
          "telemetry (b): no spec_k probe window ended")
    out["b"] = dict(
        identical=len(reqs) - len(gaps), partings=gaps,
        decisions=len(decisions), incumbent_spec_k=s["tuner_spec_k"],
        spec_chunks=s["spec_chunks"], spec_accept_rate=s["spec_accept_rate"],
        waves=d1["spec_waves_taken"], decode_steps=d1["decode_steps_taken"],
        launches={k: c1[k] for k in ("paged_attention_write",
                                     "paged_verify_attention",
                                     "paged_write_column", "paged_attention",
                                     "paged_write_columns")},
        phase_s=time.perf_counter() - t)
    del engine, sched
    log(f"telemetry (b) ({card}): " + json.dumps(out["b"]))
    out["launches"] = total
    log(f"telemetry launches ({card}): " + json.dumps(total))
    return total, out


# ---------------------------------------------------------------------------
# phase 19: the quantized-cache kernels vs plain, at the path's shapes
# ---------------------------------------------------------------------------

#: what a stale cell of a quantized plane holds in phase 19: an fp8 NaN
#: (0x7F) or, in int8, -128 (a byte the quantizer never writes), beside a
#: NaN scale
STALE_BYTE = {"int8": 0x80, "fp8": 0x7F}
#: the one number every library column says for the quantized kernels
QUANT_NO_LIBRARY = ("none: no PyTorch call quantizes rows per head into "
                    "a cache column, or reads int8/fp8 with per-column "
                    "scales")


def _stale_quant(g, kind, shape, stale):
    """Random bf16 rows ``shape`` quantized by ``quantize_kv_rows``, with
    every cell where ``stale [shape[:-1]]`` holds set to the stale byte and
    a NaN scale."""
    from apex_tpu_torch.kernels import quantize_kv_rows

    x = torch.randn(*shape, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    q, s = quantize_kv_rows(x, kind)
    q.view(torch.uint8).masked_fill_(stale[..., None], STALE_BYTE[kind])
    s.masked_fill_(stale, float("nan"))
    return q, s


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as the integer type of its element size."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _same_planes(a, b) -> bool:
    """Two lists of planes bit for bit equal (a NaN equals its own bits)."""
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _planes_err(a, b) -> float:
    return max(write_err(x.float(), y.float()) for x, y in zip(a, b))


def phase_quant_kernels():
    """The six kernels of the quantized cache against their plain versions
    at the serving path's shapes (8 rows of 16 heads of 64, horizon 192;
    a pool of 193 pages of 8, each table a random permutation of pages
    1..192; verify writes of 4 columns), for int8 and fp8, the new rows in
    bf16 (and the one-column write once in fp32). Every cell past a row's
    position, every unmapped page and the sink hold the stale byte and a
    NaN scale. Writes: data and scale planes bit-equal to plain, lanes
    clamped past 191 included. Reads: within BF16_TOL (bf16 q) and
    FP32_TOL (fp32 q) of plain, finite, and the paged read bit-equal to
    the contiguous read on the gathered planes. Timed as in phase 3 for
    int8 (fp8 beside it)."""
    from apex_tpu_torch.kernels import (
        attend_cache_quant,
        attend_cache_quant_plain,
        cache_write_columns_quant,
        cache_write_columns_quant_plain,
        paged_attention_quantized,
        paged_attention_quantized_plain,
        paged_write_column_quant,
        paged_write_column_quant_plain,
        paged_write_columns_quant,
        paged_write_columns_quant_plain,
        reset_launch_counts,
        write_column_quant,
        write_column_quant_plain,
    )
    from apex_tpu_torch.kernels.decode_attention import (
        check_positions,
        paged_gather_planes,
    )

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    B, H, D, P, MP, T = SLOTS, HEADS, HEAD_DIM, PAGE, MAX_PAGES, SPEC_T
    N, S = NUM_PAGES, MAX_PAGES * PAGE
    col = torch.arange(S, device=dev)
    names = ("decode_write_column_quant", "decode_attention_quant",
             "cache_write_columns_quant", "paged_write_column_quant",
             "paged_write_columns_quant", "paged_attention_quant")
    err = {k: dict.fromkeys(names, 0.0) for k in ("int8", "fp8")}
    err32 = {"int8": 0.0, "fp8": 0.0}
    timed = {}
    for kind in ("int8", "fp8"):
        for seed, pos_l in ((0, [0, 7, 8, 191, 63, 100, 189, 150]),
                            (1, [191, 0, 8, 7, 190, 31, 64, 188])):
            e = err[kind]
            g = torch.Generator(device=dev).manual_seed(200 + seed)
            mk = lambda *shp: torch.randn(*shp, generator=g, device=dev,
                                          dtype=bf16)
            table = (torch.randperm(N - 1, generator=g, device=dev) + 1).to(
                torch.int32).view(B, MP)
            pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
            check_positions(pos, S)
            stale = (col[None] > pos[:, None].long())[:, None, :].expand(
                B, H, S)
            kq, ks = _stale_quant(g, kind, (B, H, S, D), stale)
            vq, vs = _stale_quant(g, kind, (B, H, S, D), stale)
            all_stale = torch.ones(N, H, P, dtype=torch.bool, device=dev)
            kpq, kps = _stale_quant(g, kind, (N, H, P, D), all_stale)
            vpq, vps = _stale_quant(g, kind, (N, H, P, D), all_stale)
            tl = table.long()
            for c, pool in ((kq, kpq), (ks, kps), (vq, vpq), (vs, vps)):
                src = c.view(torch.uint8) if c.element_size() == 1 else c
                dst = (pool.view(torch.uint8) if pool.element_size() == 1
                       else pool)
                dst[tl] = src.reshape(B, H, MP, P, *src.shape[3:]).transpose(
                    1, 2)
            contig = [kq, ks, vq, vs]
            paged = [kpq, kps, vpq, vps]
            clone = lambda planes: [t.clone() for t in planes]
            q, kn, vn = mk(B, H, D), mk(B, H, D), mk(B, H, D)
            # one column, contiguous (bf16 rows, then fp32 rows) and paged
            for rows in ((kn, vn), (kn.float(), vn.float())):
                a, b_ = clone(contig), clone(contig)
                write_column_quant(*rows, *a, pos)
                write_column_quant_plain(*rows, *b_, pos)
                torch.cuda.synchronize()
                check(_same_planes(a, b_), f"write_column_quant {kind} "
                      f"{rows[0].dtype}: planes differ from plain (bitwise)")
                e["decode_write_column_quant"] = max(
                    e["decode_write_column_quant"], _planes_err(a, b_))
            kc = clone(contig)
            write_column_quant(kn, vn, *kc, pos)
            pk, pp = clone(paged), clone(paged)
            paged_write_column_quant(kn, vn, *pk, table, pos)
            paged_write_column_quant_plain(kn, vn, *pp, table, pos)
            torch.cuda.synchronize()
            check(_same_planes(pk, pp), f"paged_write_column_quant {kind}: "
                  f"pools differ from plain (bitwise)")
            e["paged_write_column_quant"] = max(
                e["paged_write_column_quant"], _planes_err(pk, pp))
            # the reads, after the writes, as on the path
            out = attend_cache_quant(q, *kc, pos)
            ref = attend_cache_quant_plain(q, *kc, pos)
            pout = paged_attention_quantized(q, *pk, table, pos)
            pref = paged_attention_quantized_plain(q, *pk, table, pos)
            gathered = attend_cache_quant(
                q, *(paged_gather_planes(x, table) for x in pk), pos)
            torch.cuda.synchronize()
            for name, o, r in (("decode_attention_quant", out, ref),
                               ("paged_attention_quant", pout, pref)):
                check(bool(torch.isfinite(o).all()),
                      f"{name} {kind}: non-finite output (stale cells "
                      f"leaked)")
                check(close(o, r, BF16_TOL),
                      f"{name} {kind} pos={pos_l}: err {max_err(o, r)}")
                e[name] = max(e[name], max_err(o, r))
            check(torch.equal(pout.view(torch.int16),
                              gathered.view(torch.int16)),
                  f"paged_attention_quant {kind}: not bit-equal to the "
                  f"contiguous read on the gathered planes")
            o32 = attend_cache_quant(q.float(), *kc, pos)
            r32 = attend_cache_quant_plain(q.float(), *kc, pos)
            p32 = paged_attention_quantized(q.float(), *pk, table, pos)
            torch.cuda.synchronize()
            check(close(o32, r32, FP32_TOL) and torch.equal(o32, p32),
                  f"quantized reads {kind} fp32: err {max_err(o32, r32)}, "
                  f"paged == contiguous {torch.equal(o32, p32)}")
            err32[kind] = max(err32[kind], max_err(o32, r32))
            # T columns, contiguous and paged (lanes past 191 clamp)
            knt, vnt = mk(B, H, T, D), mk(B, H, T, D)
            a, b_ = clone(contig), clone(contig)
            cache_write_columns_quant(knt, vnt, *a, pos)
            cache_write_columns_quant_plain(knt, vnt, *b_, pos)
            pa, pb = clone(paged), clone(paged)
            paged_write_columns_quant(knt, vnt, *pa, table, pos)
            paged_write_columns_quant_plain(knt, vnt, *pb, table, pos)
            torch.cuda.synchronize()
            check(_same_planes(a, b_), f"cache_write_columns_quant {kind}: "
                  f"planes differ from plain (bitwise)")
            check(_same_planes(pa, pb), f"paged_write_columns_quant {kind}:"
                  f" pools differ from plain (bitwise)")
            e["cache_write_columns_quant"] = max(
                e["cache_write_columns_quant"], _planes_err(a, b_))
            e["paged_write_columns_quant"] = max(
                e["paged_write_columns_quant"], _planes_err(pa, pb))
        timed[kind] = dict(
            pos=pos, pos_l=pos_l, q=q, kn=kn, vn=vn, knt=knt, vnt=vnt,
            table=table, contig=kc, paged=pk)
        log(f"quant kernels {kind}: four writes bit-exact (data and scale, "
            f"lanes past the horizon included, bf16 and fp32 rows); reads "
            f"bf16 max|out-plain| contiguous "
            f"{e['decode_attention_quant']:.3e}, paged "
            f"{e['paged_attention_quant']:.3e} (tol atol=rtol=2e-2), fp32 "
            f"{err32[kind]:.3e}; paged read bit-equal to the contiguous "
            f"read; stale bytes and NaN scales stayed masked")

    # timings with the second seed's tensors, int8 in the rows and fp8
    # beside them
    rows = {}
    for kind in ("int8", "fp8"):
        t = timed[kind]
        pos, table, q = t["pos"], t["table"], t["q"]
        kn, vn, knt, vnt = t["kn"], t["vn"], t["knt"], t["vnt"]
        kc, pk = t["contig"], t["paged"]
        pl = pos.long()
        n_cols = int((pl + 1).sum())
        n_tbl = int(((pl + P) // P).sum())
        cols_t = (pl[:, None] + torch.arange(T, device=dev)[None]).clamp(
            max=S - 1)
        distinct = lambda c: B + int((c[:, 1:] != c[:, :-1]).sum())
        # a written cell: its bf16 row read, its byte row and fp32 scale
        # written, for K and V
        cell = 2 * H * (D * 2 + D + 4)
        rd = 2 * H * (D + 4)                  # a read column, K and V
        qo = 2 * B * H * D * 2 + B * 4        # q in, out out, pos
        specs = {
            "decode_write_column_quant": (
                481, lambda: write_column_quant(kn, vn, *kc, pos),
                lambda: write_column_quant_plain(kn, vn, *kc, pos),
                B * cell + B * 4, 0),
            "cache_write_columns_quant": (
                255, lambda: cache_write_columns_quant(knt, vnt, *kc, pos),
                lambda: cache_write_columns_quant_plain(knt, vnt, *kc, pos),
                distinct(cols_t) * cell + B * 4, 0),
            "paged_write_column_quant": (
                762, lambda: paged_write_column_quant(kn, vn, *pk, table,
                                                      pos),
                lambda: paged_write_column_quant_plain(kn, vn, *pk, table,
                                                       pos),
                B * cell + B * 8, 0),
            "paged_write_columns_quant": (
                870, lambda: paged_write_columns_quant(knt, vnt, *pk, table,
                                                       pos),
                lambda: paged_write_columns_quant_plain(knt, vnt, *pk,
                                                        table, pos),
                distinct(cols_t) * cell + B * 4
                + 4 * distinct(cols_t // P), 0),
            "decode_attention_quant": (
                568, lambda: attend_cache_quant(q, *kc, pos),
                lambda: attend_cache_quant_plain(q, *kc, pos),
                qo + n_cols * rd, 4 * n_cols * H * D),
            "paged_attention_quant": (
                1075, lambda: paged_attention_quantized(q, *pk, table, pos),
                lambda: paged_attention_quantized_plain(q, *pk, table, pos),
                qo + n_cols * rd + 4 * n_tbl, 4 * n_cols * H * D),
        }
        # the bf16 writes (rows 7, 8, 13, 15) at the same shape, on bf16
        # caches and pools, timed in turns with the quantized ones
        c16 = [torch.zeros(B, H, S, D, dtype=bf16, device=dev)
               for _ in range(2)]
        p16 = [torch.zeros(N, H, P, D, dtype=bf16, device=dev)
               for _ in range(2)]
        bf16_of = {k: v[2] for k, v in _quant_write_specs(
            pos, table, H, D, c16, p16, kc, pk, (kn, vn),
            (knt, vnt)).items()}
        for name, (line, fn, plain, n_bytes, n_ops) in specs.items():
            bms, by = bound(n_bytes, n_ops, FP32_FLOPS_PER_S)
            r = dict(ms=time_ms(fn), eager_ms=eager_ms(fn),
                     plain_ms=time_ms(plain), bound_ms=bms, bound_by=by,
                     max_abs_err=err[kind][name])
            if name in bf16_of:
                turns = [time_ms(fn), time_ms(bf16_of[name]),
                         time_ms(bf16_of[name]), time_ms(fn)]
                r.update(turns_ms=statistics.median(turns[::3]),
                         bf16_ms=statistics.median(turns[1:3]))
                r["ms / bf16_ms"] = r["turns_ms"] / r["bf16_ms"]
            if kind == "fp8":
                rows[name]["fp8"] = r
                continue
            rows[name] = dict(
                name=name, route="cuda",
                source="apex_tpu_torch/csrc/decode_attention.cu",
                replaces=f"apex_tpu/kernels/decode_attention.py:{line}",
                library_ms=None, library=QUANT_NO_LIBRARY, **r,
                shape=(f"b={B} h={H} S={S} d={D}" if "paged" not in name
                       else f"b={B} h={H} P={P} pages={N} max_pages={MP} "
                       f"d={D}")
                + (f" T={T}" if "columns" in name else "")
                + (" bf16 q" if "attention" in name else " bf16 rows")
                + f", int8 planes, pos={t['pos_l']}")
    for r in rows.values():
        log(f"kernel {r['name']}: int8 {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']})"
            + (f", in turns {r['turns_ms']:.5f} against its bf16 write's "
               f"{r['bf16_ms']:.5f}" if "bf16_ms" in r else "")
            + f"; fp8 {r['fp8']['ms']:.4f} ms, plain "
            f"{r['fp8']['plain_ms']:.4f} ms at {r['shape']}")
    reset_launch_counts()
    return rows


# ---------------------------------------------------------------------------
# phase 33: the decode reads at every head width up to 128, fp16 included
# ---------------------------------------------------------------------------

#: the head widths phase 33 holds the reads at: the narrowest padded
#: width, the 2.7B's 80, one that no vector of 8 divides, and the cap
DECODE_WIDTHS = (32, 80, 100, 128)
#: fp16 outputs of kernel vs plain: both sum in fp32 (in another order)
#: and round once to fp16 (10 bits of mantissa): two fp16 ulps relative,
#: plus FP32_TOL's atol for the fp32 sums
F16_TOL = dict(atol=1e-3, rtol=2.0 ** -9)
#: the tolerance of a read against its plain version, by q's dtype
DECODE_TOL = {torch.float32: FP32_TOL, torch.bfloat16: BF16_TOL,
              torch.float16: F16_TOL}
#: the 2.7B's decode read: 8 slots of 32 heads of 80 over a horizon of
#: 1024 (its seq_len), pages of PAGE
D27_B, D27_H, D27_D, D27_S = 8, 32, 80, 1024


def _pool_of(plane, table, page: int, n_pages: int):
    """``plane [b, h, S(, d)]`` laid into a pool of ``n_pages`` pages of
    ``page`` columns through ``table [b, S / page]``; every cell no row
    maps (the sink page 0 among them) holds NaN, or a quantized plane's
    stale byte."""
    from apex_tpu_torch.kernels.decode_attention import kv_kind_of

    b, h, s = plane.shape[:3]
    tail = tuple(plane.shape[3:])
    pool = torch.empty((n_pages, h, page) + tail, dtype=plane.dtype,
                       device=plane.device)
    if plane.element_size() == 1:
        _bits(pool).fill_(STALE_BYTE[kv_kind_of(plane.dtype)])
    else:
        pool.fill_(float("nan"))
    _bits(pool)[table.long()] = _bits(plane).reshape(
        b, h, s // page, page, *tail).transpose(1, 2)
    return pool


def _hold_read(what: str, out, ref, tol, worst: dict, key) -> None:
    """A read's output finite and within ``tol`` of its plain version;
    the error goes into ``worst[key]``."""
    check(bool(torch.isfinite(out).all()),
          f"{what}: non-finite output (stale cells leaked)")
    err = max_err(out, ref)
    check(close(out, ref, tol), f"{what}: err {err} (tolerance {tol})")
    worst[key] = max(worst.get(key, 0.0), err)


# ---------------------------------------------------------------------------
# phases 3 and 15: the fused decode step (the single-column write inside the
# split read's launch) against the write + read pair and the plain twin
# ---------------------------------------------------------------------------

#: the decode shapes the fused launch is held and timed at, (slots, heads,
#: head width, horizon): the 355M's serving shape and the 2.7B's decode
#: shape (pages of PAGE when paged)
FUSED_SHAPES = {"355m": (SLOTS, HEADS, HEAD_DIM, HORIZON),
                "2p7b": (D27_B, D27_H, D27_D, D27_S)}
#: the positions each shape's fused launch is timed at: phase 3's second
#: seed's at the 355M's, phase 33's 127..1023 at the 2.7B's
FUSED_TIMED_POS = {"355m": [191, 0, 31, 32, 33, 150, 1, 96],
                   "2p7b": [(i + 1) * D27_S // D27_B - 1
                            for i in range(D27_B)]}


def fused_positions(S: int, d: int, b: int):
    """Position sets of ``b`` rows over a horizon of ``S`` at head width
    ``d``: every split's first and last column under ``read_splits(S,
    d)`` (0 and S - 1 among them), then a set that holds S, one past the
    horizon (written nowhere, read as S - 1), beside 0 and S - 1."""
    from apex_tpu_torch.kernels.decode_attention import read_splits

    cols, n = read_splits(S, d)
    edges = sorted({c for i in range(n)
                    for c in (i * cols, min((i + 1) * cols, S) - 1)})
    sets = [edges[i:i + b] for i in range(0, len(edges), b)]
    sets[-1] += [S - 2 - 3 * i for i in range(b - len(sets[-1]))]
    sets.append(([S, 0, S - 1, cols, cols - 1, S // 2, 5] * b)[:b])
    return sets


def _fused_inputs(g, shape: str, dtype, pos_l, paged: bool):
    """One decode step's operands at ``shape``: q, the new K and V rows,
    the two caches with NaN past every position (paged: laid into a pool
    of pages of PAGE through a random table, every other cell and the
    sink page NaN), the table (or None) and pos."""
    B, H, D, S = FUSED_SHAPES[shape]
    dev = torch.device("cuda")
    mk = lambda *shp: torch.randn(*shp, generator=g, device=dev, dtype=dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    stale = (torch.arange(S, device=dev)[None] > pos[:, None].long())[
        :, None, :, None]
    q, kn, vn = mk(B, H, D), mk(B, H, D), mk(B, H, D)
    kc, vc = (mk(B, H, S, D).masked_fill(stale, float("nan"))
              for _ in range(2))
    if not paged:
        return q, kn, vn, kc, vc, None, pos
    n_pages = B * (S // PAGE) + 1
    table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).to(
        torch.int32).view(B, S // PAGE)
    return (q, kn, vn, _pool_of(kc, table, PAGE, n_pages),
            _pool_of(vc, table, PAGE, n_pages), table, pos)


def fused_sides(paged: bool):
    """(fused launch, write + read pair, write alone, read alone, plain
    twin) of the contiguous (rows 7 + 10) or paged (rows 13 + 17) decode
    step, each taking (q, k_new, v_new, k, v, table, pos); the pair is the
    two stand-alone wrappers, launched one after the other."""
    from apex_tpu_torch.kernels import (
        attend_cache,
        decode_attention,
        decode_attention_plain,
        paged_attention,
        paged_decode_attention,
        paged_decode_attention_plain,
        paged_write_column,
        write_column,
    )

    if paged:
        fused = paged_decode_attention
        plain = paged_decode_attention_plain
        write = lambda q, kn, vn, k, v, t, p: paged_write_column(
            kn, vn, k, v, t, p)
        read = lambda q, kn, vn, k, v, t, p: paged_attention(q, k, v, t, p)
    else:
        fused = lambda q, kn, vn, k, v, t, p: decode_attention(
            q, kn, vn, k, v, p)
        plain = lambda q, kn, vn, k, v, t, p: decode_attention_plain(
            q, kn, vn, k, v, p)
        write = lambda q, kn, vn, k, v, t, p: write_column(kn, vn, k, v, p)
        read = lambda q, kn, vn, k, v, t, p: attend_cache(q, k, v, p)

    def pair(*a):
        write(*a)
        return read(*a)

    return fused, pair, write, read, plain


def hold_fused(paged: bool):
    """The fused launch held at both FUSED_SHAPES in fp32, bf16 and fp16
    at every set of ``fused_positions``: against the write + read pair on
    a copy of the same caches, the caches (every cell, NaN included) and
    out bit for bit; against the plain twin on a third copy, the caches
    bit for bit and out within DECODE_TOL (the contiguous plain write
    indexes pos, so the set with a position past the horizon is held
    against the pair alone there). Returns ({(shape, dtype): max |out -
    plain|}, the cases held)."""
    fused, pair, _, _, plain = fused_sides(paged)
    name = "paged_decode_attention" if paged else "decode_attention"
    g = torch.Generator(device="cuda").manual_seed(1900 + paged)
    worst, cases = {}, 0
    for shape, (B, H, D, S) in FUSED_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            for pos_l in fused_positions(S, D, B):
                q, kn, vn, k, v, table, pos = _fused_inputs(
                    g, shape, dt, pos_l, paged)
                two, one, ref = ([k.clone(), v.clone()] for _ in range(3))
                want = pair(q, kn, vn, *two, table, pos)
                out = fused(q, kn, vn, *one, table, pos)
                torch.cuda.synchronize()
                what = f"{name} {shape} {dt} pos={pos_l}"
                check(_same_planes(one, two), f"{what}: caches differ from "
                      f"the write + read pair's (bitwise)")
                check(torch.equal(_bits(out), _bits(want)), f"{what}: out "
                      f"differs from the pair's (bitwise), max "
                      f"{max_err(out, want)}")
                if paged or max(pos_l) < S:
                    got = plain(q, kn, vn, *ref, table, pos)
                    torch.cuda.synchronize()
                    check(_same_planes(one, ref), f"{what}: caches differ "
                          f"from the plain twin's (bitwise)")
                    _hold_read(what, out, got, DECODE_TOL[dt], worst,
                               (shape, str(dt)))
                else:
                    check(bool(torch.isfinite(out).all()),
                          f"{what}: non-finite output")
                cases += 1
    errs = {f"{a} {b}": e for (a, b), e in worst.items()}
    log(f"{name}: {cases} cases bit-equal to the write + read pair (caches "
        f"and out) and held against the plain twin; max|out-plain| {errs}")
    return worst, cases


def time_fused(paged: bool, shape: str) -> dict:
    """The fused launch at ``shape`` in bf16 (FUSED_TIMED_POS), timed as
    phase 3 times a kernel, beside the write + read pair, the write alone
    and the read alone in the same call (each on its own copy of the
    caches), eagerly too, its plain twin, and the bound: each input byte
    read once (q, the new rows, and the cached K and V rows of columns
    0..pos - 1, column pos coming from the new rows), each output byte
    written once (out and the new column), and (paged) the table entries
    the read needs."""
    B, H, D, S = FUSED_SHAPES[shape]
    fused, pair, write, read, plain = fused_sides(paged)
    pos_l = FUSED_TIMED_POS[shape]
    g = torch.Generator(device="cuda").manual_seed(1950 + paged)
    q, kn, vn, k, v, table, pos = _fused_inputs(g, shape, torch.bfloat16,
                                                pos_l, paged)
    runs = {key: [k.clone(), v.clone()] for key in
            ("fused", "pair", "write", "read", "plain")}
    call = lambda f, key: (lambda: f(q, kn, vn, *runs[key], table, pos))
    n_cols = sum(p + 1 for p in pos_l)
    n_bytes = 2 * (B * H * D + 2 * B * H * D + 2 * (n_cols - B) * H * D
                   + B * H * D + 2 * B * H * D) + 4 * B
    if paged:
        n_bytes += 4 * sum((p + PAGE) // PAGE for p in pos_l)
    bms, by = bound(n_bytes, 4 * n_cols * H * D, FP32_FLOPS_PER_S)
    out = dict(ms=time_ms(call(fused, "fused")),
               pair_ms=time_ms(call(pair, "pair")),
               write_ms=time_ms(call(write, "write")),
               read_ms=time_ms(call(read, "read")),
               eager_ms=eager_ms(call(fused, "fused")),
               pair_eager_ms=eager_ms(call(pair, "pair")),
               plain_ms=time_ms(call(plain, "plain")),
               bound_ms=bms, bound_by=by,
               shape=f"b={B} h={H} S={S} d={D} bf16 pos={pos_l}"
                     + (f" P={PAGE}" if paged else ""))
    log(f"{'paged_' if paged else ''}decode_attention fused at {shape}: "
        f"{out['ms']:.5f} ms (the pair {out['pair_ms']:.5f}, the write "
        f"{out['write_ms']:.5f}, the read {out['read_ms']:.5f}; eager "
        f"{out['eager_ms']:.5f} vs {out['pair_eager_ms']:.5f}), plain "
        f"{out['plain_ms']:.4f}, bound {bms:.5f} ({by})")
    return out


def fused_row(paged: bool) -> dict:
    """The kernels line's row of the fused launch: phase 3's (contiguous)
    or phase 15's (paged) holds, and its times at the 355M's shape with
    the 2.7B's under ``2p7b``."""
    worst, cases = hold_fused(paged)
    name = "paged_attention_write" if paged else "decode_attention_write"
    lines = (707, 975) if paged else (108, 339)
    row = dict(
        name=name, route="cuda",
        source="apex_tpu_torch/csrc/decode_attention.cu",
        replaces=f"apex_tpu/kernels/decode_attention.py:{lines[0]}",
        and_replaces=f"apex_tpu/kernels/decode_attention.py:{lines[1]}",
        variant="decode_read_split_kernel<T, T, DP, %s> with the new rows "
                "(the write inside the read's launch)"
                % ("true" if paged else "false"),
        max_abs_err=max(worst.values()), bit_equal_to_pair=True,
        cases_held=cases, library_ms=None,
        library="none: no one PyTorch call writes a cache column and "
                "attends over it",
        **time_fused(paged, "355m"))
    row["2p7b"] = time_fused(paged, "2p7b")
    return row


# ---------------------------------------------------------------------------
# phase 15: the speculative verify in one launch (the multi-column write
# inside a T-row split read) against the write alone, the single read at
# every query row's position and the plain twin
# ---------------------------------------------------------------------------

#: the query rows a (batch, head) row the verify launch is held at: the
#: serving path's spec_k + 1, and the route's largest
VERIFY_ROWS = (SPEC_T, 8)


def verify_positions(S: int, d: int, b: int, t: int):
    """:func:`fused_positions`, then a set whose T lanes pass the horizon
    (clamped onto S - 1: a row at S - 1, one whose lanes end past it, one
    past the horizon) beside lanes across a split's edge."""
    from apex_tpu_torch.kernels.decode_attention import read_splits

    cols, _ = read_splits(S, d)
    return fused_positions(S, d, b) + [(
        [S - 1, S - t // 2, S - t + 1, S + 3, cols - t // 2, 2 * cols - 1,
         0, S // 2] * b)[:b]]


def _verify_inputs(g, shape: str, dtype, t: int, pos_l):
    """One verify's operands at ``shape``: q and the new K and V rows [b,
    h, T, d], the two caches with NaN past every position, the same rows
    in pools of pages of PAGE through a random table (every other cell and
    the sink page NaN), the table and pos."""
    B, H, D, S = FUSED_SHAPES[shape]
    dev = torch.device("cuda")
    mk = lambda *shp: torch.randn(*shp, generator=g, device=dev, dtype=dtype)
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    stale = (torch.arange(S, device=dev)[None] > pos[:, None].long())[
        :, None, :, None]
    q, kn, vn = mk(B, H, t, D), mk(B, H, t, D), mk(B, H, t, D)
    kc, vc = (mk(B, H, S, D).masked_fill(stale, float("nan"))
              for _ in range(2))
    n_pages = B * (S // PAGE) + 1
    table = (torch.randperm(n_pages - 1, generator=g, device=dev) + 1).to(
        torch.int32).view(B, S // PAGE)
    return (q, kn, vn, kc, vc, _pool_of(kc, table, PAGE, n_pages),
            _pool_of(vc, table, PAGE, n_pages), table, pos)


def hold_verify():
    """The verify launch, contiguous and paged, at both FUSED_SHAPES in
    fp32, bf16 and fp16 with T of VERIFY_ROWS at every set of
    ``verify_positions``: the caches (pools) bit-equal to
    ``cache_write_columns`` (``paged_write_columns``) alone on a copy, and
    to the plain twin's on a third copy; every query row bit-equal to the
    single read (``attend_cache``, ``paged_attention``) at min(pos + t, S -
    1) over the written copy; the paged output bit-equal to the contiguous
    one; out within DECODE_TOL of the plain twin. Returns ({(layout, shape,
    dtype): max |out - plain|}, the cases held)."""
    from apex_tpu_torch.kernels import (
        attend_cache,
        cache_write_columns,
        decode_verify_attention,
        decode_verify_attention_plain,
        paged_attention,
        paged_verify_attention,
        paged_verify_attention_plain,
        paged_write_columns,
    )

    g = torch.Generator(device="cuda").manual_seed(2000)
    worst, cases = {}, 0
    for shape, (B, H, D, S) in FUSED_SHAPES.items():
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            for t in VERIFY_ROWS:
                for pos_l in verify_positions(S, D, B, t):
                    q, kn, vn, kc, vc, kp, vp, table, pos = _verify_inputs(
                        g, shape, dt, t, pos_l)
                    outs = {}
                    for layout, planes in (("contiguous", (kc, vc)),
                                           ("paged", (kp, vp))):
                        one, two, ref = ([x.clone() for x in planes]
                                         for _ in range(3))
                        what = (f"verify {layout} {shape} {dt} T={t} "
                                f"pos={pos_l}")
                        if layout == "paged":
                            out = paged_verify_attention(q, kn, vn, *one,
                                                         table, pos)
                            paged_write_columns(kn, vn, *two, table, pos)
                            got = paged_verify_attention_plain(
                                q, kn, vn, *ref, table, pos)
                            single = lambda qt, p: paged_attention(
                                qt, *two, table, p)
                        else:
                            out = decode_verify_attention(q, kn, vn, *one,
                                                          pos)
                            cache_write_columns(kn, vn, *two, pos)
                            got = decode_verify_attention_plain(
                                q, kn, vn, *ref, pos)
                            single = lambda qt, p: attend_cache(qt, *two, p)
                        rows = [single(q[:, :, i].contiguous(),
                                       (pos + i).clamp(max=S - 1))
                                for i in range(t)]
                        torch.cuda.synchronize()
                        check(_same_planes(one, two), f"{what}: caches "
                              f"differ from the write alone's (bitwise)")
                        check(_same_planes(one, ref), f"{what}: caches "
                              f"differ from the plain twin's (bitwise)")
                        for i, want in enumerate(rows):
                            check(torch.equal(_bits(out[:, :, i]),
                                              _bits(want)),
                                  f"{what}: query row {i} differs from the "
                                  f"single read at pos + {i} (bitwise), max "
                                  f"{max_err(out[:, :, i], want)}")
                        _hold_read(what, out, got, DECODE_TOL[dt], worst,
                                   (layout, shape, str(dt)))
                        outs[layout] = out
                    check(torch.equal(_bits(outs["paged"]),
                                      _bits(outs["contiguous"])),
                          f"verify {shape} {dt} T={t} pos={pos_l}: paged out "
                          f"differs from contiguous (bitwise)")
                    cases += 1
    errs = {" ".join(k): e for k, e in worst.items()}
    log(f"verify: {cases} cases, contiguous and paged: caches bit-equal to "
        f"the multi-column write alone and to the plain twin, every query "
        f"row bit-equal to the single read at its position, paged == "
        f"contiguous; max|out-plain| {errs}")
    return worst, cases


#: fp32 head widths whose split read fills the 48 KB of shared memory a
#: block holds without opting in (its ring 128 x d x 4 bytes, beside its
#: static arrays): the launch must opt in for the static bytes too
WIDE_FP32_WIDTHS = (88, 96)


def hold_wide_fp32():
    """The contiguous and paged reads and verify launches on fp32 rows of
    WIDE_FP32_WIDTHS (2 rows of 2 heads, horizon 256, pages of PAGE, NaN
    past every position): each launches, within FP32_TOL of its plain
    twin, every verify query row bit-equal to the single read at its
    position. Returns the largest |out - plain|."""
    from apex_tpu_torch.kernels import (
        attend_cache,
        attend_cache_plain,
        decode_verify_attention,
        decode_verify_attention_plain,
        paged_attention,
        paged_attention_plain,
        paged_verify_attention,
    )

    g = torch.Generator(device="cuda").manual_seed(2070)
    B, H, S, t = 2, 2, 256, SPEC_T
    worst = 0.0
    for d in WIDE_FP32_WIDTHS:
        pos_l = [S - 2, 100]
        mk = lambda *shp: torch.randn(*shp, generator=g, device="cuda")
        pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
        stale = (torch.arange(S, device="cuda")[None] > pos[:, None].long())[
            :, None, :, None]
        q, kn, vn = mk(B, H, t, d), mk(B, H, t, d), mk(B, H, t, d)
        kc, vc = (mk(B, H, S, d).masked_fill(stale, float("nan"))
                  for _ in range(2))
        n_pages = B * (S // PAGE) + 1
        table = (torch.randperm(n_pages - 1, generator=g, device="cuda")
                 + 1).to(torch.int32).view(B, S // PAGE)
        kp, vp = (_pool_of(x, table, PAGE, n_pages) for x in (kc, vc))
        what = f"fp32 rows of {d}"
        q0 = q[:, :, 0].contiguous()
        for name, got, want in (
                ("attend_cache", attend_cache(q0, kc, vc, pos),
                 attend_cache_plain(q0, kc, vc, pos)),
                ("paged_attention", paged_attention(q0, kp, vp, table, pos),
                 attend_cache_plain(q0, kc, vc, pos))):
            _hold_read(f"{name} {what}", got, want, FP32_TOL, {}, name)
            worst = max(worst, max_err(got, want))
        ref = [kc.clone(), vc.clone()]
        want = decode_verify_attention_plain(q, kn, vn, *ref, pos)
        for layout, out in (
                ("contiguous", decode_verify_attention(q, kn, vn, kc, vc,
                                                       pos)),
                ("paged", paged_verify_attention(q, kn, vn, kp, vp, table,
                                                 pos))):
            _hold_read(f"verify {layout} {what}", out, want, FP32_TOL, {},
                       layout)
            worst = max(worst, max_err(out, want))
            for i in range(t):
                one = attend_cache(q[:, :, i].contiguous(), *ref,
                                   (pos + i).clamp(max=S - 1))
                check(torch.equal(out[:, :, i], one),
                      f"verify {layout} {what}: query row {i} differs from "
                      f"the single read (bitwise)")
    log(f"fp32 rows of {WIDE_FP32_WIDTHS}: the reads and the verify "
        f"launches run, max|out-plain| {worst:.3e}")
    return worst


def verify_sides(paged: bool):
    """(verify launch, the parent's pair, the write alone, plain twin) of
    the contiguous (row 8) or paged (row 15) verify, each taking (q, k_new,
    v_new, k, v, table, pos); the pair is what the parent's
    ``_decode_attend_multi`` / ``_paged_attend_multi`` ran on the kernel
    impl: the write kernel, then (paged: the gather of both pools, then)
    ``gpt._xla_verify_read``."""
    from apex_tpu_torch.kernels import (
        cache_write_columns,
        decode_verify_attention,
        decode_verify_attention_plain,
        paged_verify_attention,
        paged_verify_attention_plain,
        paged_write_columns,
    )
    from apex_tpu_torch.kernels.decode_attention import paged_gather_xla
    from apex_tpu_torch.models import gpt

    if paged:
        fused = paged_verify_attention
        plain = paged_verify_attention_plain
        write = lambda q, kn, vn, k, v, t, p: paged_write_columns(
            kn, vn, k, v, t, p)
        view = lambda k, v, t: (paged_gather_xla(k, t),
                                paged_gather_xla(v, t))
    else:
        fused = lambda q, kn, vn, k, v, t, p: decode_verify_attention(
            q, kn, vn, k, v, p)
        plain = lambda q, kn, vn, k, v, t, p: decode_verify_attention_plain(
            q, kn, vn, k, v, p)
        write = lambda q, kn, vn, k, v, t, p: cache_write_columns(
            kn, vn, k, v, p)
        view = lambda k, v, t: (k, v)

    def pair(q, kn, vn, k, v, t, p):
        write(q, kn, vn, k, v, t, p)
        return gpt._xla_verify_read(q, *view(k, v, t), p)

    return fused, pair, write, plain


def time_verify(paged: bool, shape: str) -> dict:
    """The verify launch at ``shape`` in bf16 with T = SPEC_T
    (FUSED_TIMED_POS), timed as phase 3 times a kernel, beside the
    parent's pair (the write, then the materialised read), the write alone
    (each on its own copy of the caches), eagerly too, the read's library
    call (SDPA over the written caches with a boolean [b, 1, T, S] mask),
    the plain twin, and the bound: each input byte read once (q, the new
    rows that land, the cached K and V rows of columns 0..pos - 1, the new
    columns coming from the new rows; paged, the table entries the read
    needs),
    each output byte written once (out and the new columns), and 4 d
    operations a (query row, column) scored and summed."""
    from apex_tpu_torch.kernels.decode_attention import paged_gather_xla

    B, H, D, S = FUSED_SHAPES[shape]
    t = SPEC_T
    fused, pair, write, plain = verify_sides(paged)
    pos_l = FUSED_TIMED_POS[shape]
    g = torch.Generator(device="cuda").manual_seed(2050 + paged)
    q, kn, vn, kc, vc, kp, vp, table, pos = _verify_inputs(
        g, shape, torch.bfloat16, t, pos_l)
    planes = (kp, vp) if paged else (kc, vc)
    runs = {key: [x.clone() for x in planes] for key in
            ("fused", "pair", "write", "plain")}
    call = lambda f, key: (lambda: f(q, kn, vn, *runs[key], table, pos))
    last = [min(p + t - 1, S - 1) for p in pos_l]
    new = [min(p + t - 1, S - 1) - min(p, S - 1) + 1 for p in pos_l]
    n_cols = sum(min(p + i, S - 1) + 1 for p in pos_l for i in range(t))
    n_bytes = 2 * H * D * (B * t + 2 * sum(new)
                           + 2 * sum(c + 1 - n for c, n in zip(last, new))
                           + B * t + 2 * sum(new)) + 4 * B
    if paged:
        n_bytes += 4 * sum(c // PAGE + 1 for c in last)
    bms, by = bound(n_bytes, 4 * n_cols * H * D, FP32_FLOPS_PER_S)
    written = [x.clone() for x in planes]
    write(q, kn, vn, *written, table, pos)
    kw, vw = ((paged_gather_xla(x, table) for x in written) if paged
              else written)
    mask = (torch.arange(S, device="cuda")[None, None]
            <= (pos.long()[:, None] + torch.arange(t, device="cuda")[None])[
                :, :, None])[:, None]
    out = dict(ms=time_ms(call(fused, "fused")),
               pair_ms=time_ms(call(pair, "pair")),
               write_ms=time_ms(call(write, "write")),
               eager_ms=eager_ms(call(fused, "fused")),
               pair_eager_ms=eager_ms(call(pair, "pair")),
               plain_ms=time_ms(call(plain, "plain")),
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   q, kw, vw, attn_mask=mask)),
               bound_ms=bms, bound_by=by,
               shape=f"b={B} h={H} T={t} S={S} d={D} bf16 pos={pos_l}"
                     + (f" P={PAGE}" if paged else ""))
    log(f"{'paged' if paged else 'decode'}_verify_attention at {shape}: "
        f"{out['ms']:.5f} ms (the parent's pair {out['pair_ms']:.5f}, the "
        f"write {out['write_ms']:.5f}; eager {out['eager_ms']:.5f} vs "
        f"{out['pair_eager_ms']:.5f}), SDPA {out['library_ms']:.5f}, plain "
        f"{out['plain_ms']:.4f}, bound {bms:.5f} ({by})")
    return out


def verify_rows() -> dict:
    """The kernels line's rows of the verify launch, contiguous and paged:
    :func:`hold_verify`'s holds, and the times at the 355M's shape with
    the 2.7B's under ``2p7b``."""
    worst, cases = hold_verify()
    wide = hold_wide_fp32()
    rows = {}
    for paged, name, line in ((False, "decode_verify_attention", 169),
                              (True, "paged_verify_attention", 811)):
        layout = "paged" if paged else "contiguous"
        rows[name] = dict(
            name=name, route="cuda",
            source="apex_tpu_torch/csrc/decode_verify.cu",
            replaces=f"apex_tpu/kernels/decode_attention.py:{line}",
            and_replaces="apex_tpu/models/gpt.py:%d (the verify's "
                         "materialised read)" % (1803 if paged else 1878),
            variant="decode_verify_split_kernel<T, DP, R, %s> (the "
                    "multi-column write inside a T-row split read)"
                    % ("true" if paged else "false"),
            max_abs_err=max(e for k, e in worst.items() if k[0] == layout),
            rows_bit_equal_to_single_read=True, cases_held=cases,
            wide_fp32_max_abs_err=wide,
            library="F.scaled_dot_product_attention with a boolean [b, 1, "
                    "T, S] mask over the written caches (the read alone)",
            **time_verify(paged, "355m"))
        rows[name]["2p7b"] = time_verify(paged, "2p7b")
    return rows


#: the horizon of phase 33's split-edge reads: not a multiple of any
#: split's column count (read_splits gives 32 or 64 columns at
#: DECODE_WIDTHS), so the last split is short
SPLIT_EDGE_S = 200
#: the page sizes the paged split read is held at over that horizon: a
#: page a column, PAGE, and pages of 25 and 40 columns, which cross the
#: sub-tiles' 32-column edges (a sub-tile touches 32, 4, 2 or 1 pages)
SPLIT_EDGE_PAGES = (1, PAGE, 25, 40)


def _split_edge_reads(worst: dict) -> dict:
    """Phase 33's split edges: the four reads over a horizon of
    SPLIT_EDGE_S columns at every width of DECODE_WIDTHS, the plain ones
    (rows 10 and 17) in fp32, bf16 and fp16, the quantized ones (rows 12
    and 18) over int8 and fp8 planes with q in each of the three, with
    the rows' positions on the edges of ``read_splits(SPLIT_EDGE_S,
    d)``'s splits (0, L - 1, L, 2L - 1, 2L, the last split's first
    column, the one before it, and the horizon's last) and NaN (or the
    stale byte and a NaN scale) past every position, in every unmapped
    page and in the sink: each read within DECODE_TOL of its plain
    version and finite, the paged read at every page size of
    SPLIT_EDGE_PAGES bit-equal to the contiguous one, and a second launch
    of each bit-equal to the first. Returns {d: (split_cols,
    n_splits)}."""
    from apex_tpu_torch.kernels import (
        attend_cache,
        attend_cache_plain,
        attend_cache_quant,
        attend_cache_quant_plain,
        paged_attention,
        paged_attention_plain,
        paged_attention_quantized,
        paged_attention_quantized_plain,
    )
    from apex_tpu_torch.kernels.decode_attention import read_splits

    dev = torch.device("cuda")
    B, H, S = SLOTS, 4, SPLIT_EDGE_S
    dtypes = (torch.float32, torch.bfloat16, torch.float16)
    geometry = {}
    for d in DECODE_WIDTHS:
        L, n = read_splits(S, d)
        check(S % L != 0 and n > 2, f"split edges d={d}: {n} splits of {L} "
              f"columns do not leave a short last split of {S}")
        geometry[d] = (L, n)
        pos_l = [0, L - 1, L, 2 * L - 1, 2 * L, (n - 1) * L,
                 (n - 1) * L - 1, S - 1]
        pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
        stale = (torch.arange(S, device=dev)[None] > pos[:, None].long())[
            :, None, :].expand(B, H, S)
        g = torch.Generator(device=dev).manual_seed(3400 + d)
        tables = {P: (torch.randperm(B * (S // P), generator=g, device=dev)
                      + 1).to(torch.int32).view(B, S // P)
                  for P in SPLIT_EDGE_PAGES}
        # (the contiguous read's name, the storage kind ("" for rows in
        # q's dtype), q's dtype, the planes)
        cases = []
        for dt in dtypes:
            cases.append(("decode_attention", "", dt, [
                torch.randn(B, H, S, d, generator=g, device=dev).to(
                    dt).masked_fill(stale[..., None], float("nan"))
                for _ in range(2)]))
        for kind in ("int8", "fp8"):
            planes = [*_stale_quant(g, kind, (B, H, S, d), stale),
                      *_stale_quant(g, kind, (B, H, S, d), stale)]
            cases += [("decode_attention_quant", kind, dt, planes)
                      for dt in dtypes]
        for name, kind, dt, planes in cases:
            if kind:
                read, plain = attend_cache_quant, attend_cache_quant_plain
                pname, pread, pplain = (
                    "paged_attention_quant", paged_attention_quantized,
                    paged_attention_quantized_plain)
            else:
                read, plain = attend_cache, attend_cache_plain
                pname, pread, pplain = (
                    "paged_attention", paged_attention,
                    paged_attention_plain)
            tag = (f"split edges d={d} {kind + ' ' if kind else ''}"
                   f"{str(dt)[6:]}{' q' if kind else ''} L={L} n={n}")
            key = (d, kind, dt) if kind else (d, dt)
            q = torch.randn(B, H, d, generator=g, device=dev).to(dt)
            out, out2 = (read(q, *planes, pos) for _ in range(2))
            torch.cuda.synchronize()
            _hold_read(f"{name} {tag}", out, plain(q, *planes, pos),
                       DECODE_TOL[dt], worst, (name, *key))
            check(torch.equal(_bits(out2), _bits(out)),
                  f"{name} {tag}: two launches differ")
            for P, table in tables.items():
                N = B * (S // P) + 1
                pools = [_pool_of(x, table, P, N) for x in planes]
                pout, pout2 = (pread(q, *pools, table, pos)
                               for _ in range(2))
                torch.cuda.synchronize()
                _hold_read(f"{pname} {tag} P={P}", pout,
                           pplain(q, *pools, table, pos), DECODE_TOL[dt],
                           worst, (pname, *key))
                check(torch.equal(_bits(pout), _bits(out)),
                      f"{pname} {tag} P={P}: not bit-equal to the "
                      f"contiguous read on the same bytes")
                check(torch.equal(_bits(pout2), _bits(pout)),
                      f"{pname} {tag} P={P}: two launches differ")
    return geometry


#: the quantized writes' matrix (phase 33): the head widths, and the 8
#: rows' positions over a horizon of 192 by lanes T: -1 (never written),
#: 0, 191 and, for one column, 192 (outside the horizon: not written);
#: for SPEC_T columns 189..191, whose lanes clamp onto column 191
QW_WIDTHS = (32, 64, 80, 100, 128)
QW_POS = {1: [0, 191, -1, 192, 7, 100, 190, 8],
          SPEC_T: [0, 191, -1, 189, 190, 63, 188, 8]}


def _touched(pos_l, t: int, smax: int, h: int, table=None, page=None):
    """The cells a write of ``t`` lanes at ``pos_l`` must write, as a
    boolean mask ``[rows or pages, h, columns]``: lane j of row b at
    column pos + j when that is >= 0, clamped onto smax - 1 for t > 1,
    dropped at or past smax for t = 1; through ``table`` for the pools."""
    b = len(pos_l)
    if table is None:
        mask = torch.zeros(b, h, smax, dtype=torch.bool)
    else:
        mask = torch.zeros(table.numel() + 1, h, page, dtype=torch.bool)
        tbl = table.cpu()
    for r, p in enumerate(pos_l):
        for j in range(t):
            c = p + j
            if c < 0 or (t == 1 and c >= smax):
                continue
            c = min(c, smax - 1)
            if table is None:
                mask[r, :, c] = True
            else:
                mask[int(tbl[r, c // page]), :, c % page] = True
    return mask


def _quant_write_matrix() -> int:
    """The four quantized writes (rows 9, 11, 14, 16) bit-equal to their
    plain twins at every width of QW_WIDTHS, int8 and fp8, fp32, bf16 and
    fp16 rows, contiguous and paged (pools of 193 pages of 8 under a random
    table), one column and SPEC_T at QW_POS: on planes filled with the
    stale byte and NaN scales, every cell the write must touch
    (``_touched``) holds a finite scale and every other cell, data and
    scale, comes back with its stale bits. Returns the cases held."""
    from apex_tpu_torch.kernels import (
        cache_write_columns_quant,
        cache_write_columns_quant_plain,
        paged_write_column_quant,
        paged_write_column_quant_plain,
        paged_write_columns_quant,
        paged_write_columns_quant_plain,
        write_column_quant,
        write_column_quant_plain,
    )
    from apex_tpu_torch.kernels.decode_attention import kv_storage_dtype

    dev = torch.device("cuda")
    B, H, P, S = SLOTS, 4, PAGE, HORIZON
    MP, N = S // P, SLOTS * (S // P) + 1
    writes = {(1, False): (write_column_quant, write_column_quant_plain),
              (SPEC_T, False): (cache_write_columns_quant,
                                cache_write_columns_quant_plain),
              (1, True): (paged_write_column_quant,
                          paged_write_column_quant_plain),
              (SPEC_T, True): (paged_write_columns_quant,
                               paged_write_columns_quant_plain)}
    n = 0
    for d in QW_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(3400 + d)
        table = (torch.randperm(N - 1, generator=g, device=dev) + 1).to(
            torch.int32).view(B, MP)
        for kind in ("int8", "fp8"):
            def stale(*cells):
                data = torch.full((*cells, d), STALE_BYTE[kind],
                                  dtype=torch.uint8, device=dev)
                return [data.view(kv_storage_dtype(kind)),
                        torch.full(cells, float("nan"), device=dev)]
            planes = {False: stale(B, H, S) + stale(B, H, S),
                      True: stale(N, H, P) + stale(N, H, P)}
            for dt in (torch.float32, torch.bfloat16, torch.float16):
                for (t, paged), (fn, plain) in writes.items():
                    pos_l = QW_POS[t]
                    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
                    shp = (B, H, d) if t == 1 else (B, H, t, d)
                    kn, vn = (torch.randn(*shp, generator=g, device=dev)
                              .to(dt) for _ in range(2))
                    tbl = (table,) if paged else ()
                    a = [x.clone() for x in planes[paged]]
                    b_ = [x.clone() for x in planes[paged]]
                    fn(kn, vn, *a, *tbl, pos)
                    plain(kn, vn, *b_, *tbl, pos)
                    torch.cuda.synchronize()
                    what = (f"{fn.__name__} d={d} {kind} {str(dt)[6:]} "
                            f"rows T={t}")
                    check(_same_planes(a, b_), f"{what}: planes differ from "
                          f"plain (bitwise)")
                    hit = _touched(pos_l, t, S if not paged else MP * P, H,
                                   table if paged else None, P).to(dev)
                    for data, sc in ((a[0], a[1]), (a[2], a[3])):
                        check(bool((_bits(data)[~hit] == STALE_BYTE[kind])
                                   .all())
                              and bool(torch.isnan(sc[~hit]).all())
                              and bool(torch.isfinite(sc[hit]).all()),
                              f"{what}: a cell outside the write changed, "
                              f"or a written scale is not finite")
                    n += 1
    return n


def phase_decode_widths():
    """Phase 33: the four decode reads (rows 10, 12, 17, 18) at the head
    widths of DECODE_WIDTHS against their plain versions on the card: the
    plain reads with fp32, bf16 and fp16 caches, the quantized reads over
    int8 and fp8 planes with q in each of the three; 8 rows of 4 heads
    over a horizon of 192 (positions 0, 7, 8, 191 among them), pools of
    193 pages of 8 (each table a random permutation of pages 1..192),
    NaN (or the stale byte and a NaN scale) past every row's position, in
    every unmapped page and in the sink. Each read within DECODE_TOL of
    its plain version and finite, and the paged read bit-equal to the
    contiguous read on the same bytes. At each width the fp16 column
    writes (plain and quantized, one and SPEC_T columns, contiguous and
    paged) are bit-equal to their plain versions. The split reads' edges
    (``_split_edge_reads``, all four reads) come next. Then each read at
    the 2.7B's decode shape (b=8, 32 heads of 80, horizon 1024, positions
    127, 255, ..., 1023; bf16, int8 planes and fp8 beside), held the same
    way and against a second launch, bit for bit, and timed as in phase
    3, with its byte bound, and for row 10 SDPA. Returns {row name: its
    d=80 entry with its split geometry}."""
    from apex_tpu_torch.kernels import (
        attend_cache,
        attend_cache_plain,
        attend_cache_quant,
        attend_cache_quant_plain,
        cache_write_columns,
        cache_write_columns_plain,
        cache_write_columns_quant,
        cache_write_columns_quant_plain,
        paged_attention,
        paged_attention_plain,
        paged_attention_quantized,
        paged_attention_quantized_plain,
        paged_write_column,
        paged_write_column_plain,
        paged_write_column_quant,
        paged_write_column_quant_plain,
        paged_write_columns,
        paged_write_columns_plain,
        paged_write_columns_quant,
        paged_write_columns_quant_plain,
        reset_launch_counts,
        write_column,
        write_column_plain,
        write_column_quant,
        write_column_quant_plain,
    )
    from apex_tpu_torch.kernels.decode_attention import read_splits

    dev = torch.device("cuda")
    f16 = torch.float16
    dtypes = (torch.float32, torch.bfloat16, f16)
    B, H, P, S = SLOTS, 4, PAGE, HORIZON
    MP, N = S // P, SLOTS * (S // P) + 1
    pos_l = [0, 191, 7, 8, 100, 63, 150, 31]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    stale = (torch.arange(S, device=dev)[None] > pos[:, None].long())[
        :, None, :].expand(B, H, S)
    worst = {}
    clone = lambda ts: [t.clone() for t in ts]
    for d in DECODE_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(3300 + d)
        rnd = lambda *shp: torch.randn(*shp, generator=g, device=dev)
        table = (torch.randperm(N - 1, generator=g, device=dev) + 1).to(
            torch.int32).view(B, MP)
        for dt in dtypes:
            tag = f"d={d} {str(dt)[6:]}"
            q = rnd(B, H, d).to(dt)
            kc, vc = (rnd(B, H, S, d).to(dt).masked_fill(
                stale[..., None], float("nan")) for _ in range(2))
            kp, vp = (_pool_of(x, table, P, N) for x in (kc, vc))
            out = attend_cache(q, kc, vc, pos)
            pout = paged_attention(q, kp, vp, table, pos)
            torch.cuda.synchronize()
            _hold_read(f"decode_attention {tag}", out,
                       attend_cache_plain(q, kc, vc, pos), DECODE_TOL[dt],
                       worst, ("decode_attention", d, dt))
            _hold_read(f"paged_attention {tag}", pout,
                       paged_attention_plain(q, kp, vp, table, pos),
                       DECODE_TOL[dt], worst, ("paged_attention", d, dt))
            check(torch.equal(_bits(pout), _bits(out)),
                  f"paged_attention {tag}: not bit-equal to the contiguous "
                  f"read on the same bytes")
            if dt != f16:
                continue
            # the fp16 column writes, one column and SPEC_T (lanes past
            # the horizon clamp), contiguous and paged
            kn, vn = rnd(B, H, d).half(), rnd(B, H, d).half()
            knt, vnt = rnd(B, H, SPEC_T, d).half(), rnd(B, H, SPEC_T, d).half()
            for name, fn, plain, new, dst, tbl in (
                    ("write_column", write_column, write_column_plain,
                     (kn, vn), (kc, vc), ()),
                    ("cache_write_columns", cache_write_columns,
                     cache_write_columns_plain, (knt, vnt), (kc, vc), ()),
                    ("paged_write_column", paged_write_column,
                     paged_write_column_plain, (kn, vn), (kp, vp),
                     (table,)),
                    ("paged_write_columns", paged_write_columns,
                     paged_write_columns_plain, (knt, vnt), (kp, vp),
                     (table,))):
                a, b_ = clone(dst), clone(dst)
                fn(*new, *a, *tbl, pos)
                plain(*new, *b_, *tbl, pos)
                torch.cuda.synchronize()
                check(_same_planes(a, b_), f"{name} {tag}: caches differ "
                      f"from the plain write (bitwise)")
        for kind in ("int8", "fp8"):
            planes = [*_stale_quant(g, kind, (B, H, S, d), stale),
                      *_stale_quant(g, kind, (B, H, S, d), stale)]
            pools = [_pool_of(x, table, P, N) for x in planes]
            for dt in dtypes:
                tag = f"d={d} {kind} {str(dt)[6:]} q"
                q = rnd(B, H, d).to(dt)
                out = attend_cache_quant(q, *planes, pos)
                pout = paged_attention_quantized(q, *pools, table, pos)
                torch.cuda.synchronize()
                _hold_read(f"decode_attention_quant {tag}", out,
                           attend_cache_quant_plain(q, *planes, pos),
                           DECODE_TOL[dt], worst,
                           ("decode_attention_quant", d, kind, dt))
                _hold_read(f"paged_attention_quant {tag}", pout,
                           paged_attention_quantized_plain(q, *pools, table,
                                                           pos),
                           DECODE_TOL[dt], worst,
                           ("paged_attention_quant", d, kind, dt))
                check(torch.equal(_bits(pout), _bits(out)),
                      f"paged_attention_quant {tag}: not bit-equal to the "
                      f"contiguous read on the same bytes")
            # fp16 rows into the four quantized writes
            kn, vn = rnd(B, H, d).half(), rnd(B, H, d).half()
            knt, vnt = rnd(B, H, SPEC_T, d).half(), rnd(B, H, SPEC_T, d).half()
            for name, fn, plain, new, dst, tbl in (
                    ("write_column_quant", write_column_quant,
                     write_column_quant_plain, (kn, vn), planes, ()),
                    ("cache_write_columns_quant", cache_write_columns_quant,
                     cache_write_columns_quant_plain, (knt, vnt), planes,
                     ()),
                    ("paged_write_column_quant", paged_write_column_quant,
                     paged_write_column_quant_plain, (kn, vn), pools,
                     (table,)),
                    ("paged_write_columns_quant", paged_write_columns_quant,
                     paged_write_columns_quant_plain, (knt, vnt), pools,
                     (table,))):
                a, b_ = clone(dst), clone(dst)
                fn(*new, *a, *tbl, pos)
                plain(*new, *b_, *tbl, pos)
                torch.cuda.synchronize()
                check(_same_planes(a, b_), f"{name} d={d} {kind} fp16 "
                      f"rows: planes differ from plain (bitwise)")
    edges = _split_edge_reads(worst)
    qw_cases = _quant_write_matrix()
    log(f"quantized writes: {qw_cases} cases bit-equal to plain (d "
        f"{QW_WIDTHS}; int8, fp8; fp32, bf16, fp16 rows; contiguous and "
        f"paged; T 1 and {SPEC_T} at {QW_POS}); cells outside each write "
        f"kept their stale bytes and NaN scales")
    top = {}
    for k, v in worst.items():
        top[k[0]] = max(top.get(k[0], 0.0), v)
    log(f"decode reads at d {DECODE_WIDTHS} (fp32, bf16, fp16; int8 and "
        f"fp8 planes with q in each): max|out-plain| {json.dumps(top)} "
        f"(DECODE_TOL by q's dtype); paged reads bit-equal to contiguous; "
        f"fp16 writes bit-exact; rows 10, 12, 17 and 18 at positions on "
        f"the split edges of a {SPLIT_EDGE_S}-column horizon ((L, n) by d: "
        f"{edges}) held, paged (pages of {SPLIT_EDGE_PAGES}) bit-equal to "
        f"contiguous, two launches bit-equal")

    # the 2.7B's decode read: hold and time each kernel
    B2, H2, D2, S2 = D27_B, D27_H, D27_D, D27_S
    MP2, N2 = S2 // P, D27_B * (S2 // P) + 1
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3327)
    pos_l = [(i + 1) * S2 // B2 - 1 for i in range(B2)]
    pos = torch.tensor(pos_l, dtype=torch.int32, device=dev)
    stale = (torch.arange(S2, device=dev)[None] > pos[:, None].long())[
        :, None, :].expand(B2, H2, S2)
    table = (torch.randperm(N2 - 1, generator=g, device=dev) + 1).to(
        torch.int32).view(B2, MP2)
    mk = lambda *shp: torch.randn(*shp, generator=g, device=dev, dtype=bf16)
    q = mk(B2, H2, D2)
    kc, vc = (mk(B2, H2, S2, D2).masked_fill(stale[..., None], float("nan"))
              for _ in range(2))
    kp, vp = (_pool_of(x, table, P, N2) for x in (kc, vc))
    quant = {kind: [*_stale_quant(g, kind, (B2, H2, S2, D2), stale),
                    *_stale_quant(g, kind, (B2, H2, S2, D2), stale)]
             for kind in ("int8", "fp8")}
    qpools = {kind: [_pool_of(x, table, P, N2) for x in planes]
              for kind, planes in quant.items()}
    pl = pos.long()
    n_cols = int((pl + 1).sum())
    n_tbl = int(((pl + P) // P).sum())       # table entries the read needs
    qo = 2 * B2 * H2 * D2 * 2 + B2 * 4       # q in, out out, pos
    mask = (torch.arange(S2, device=dev)[None] <= pl[:, None])[
        :, None, None, :]
    specs = {
        "decode_attention": (
            lambda: attend_cache(q, kc, vc, pos),
            lambda: attend_cache_plain(q, kc, vc, pos),
            qo + 2 * n_cols * H2 * D2 * 2),
        "paged_attention": (
            lambda: paged_attention(q, kp, vp, table, pos),
            lambda: paged_attention_plain(q, kp, vp, table, pos),
            qo + 2 * n_cols * H2 * D2 * 2 + 4 * n_tbl),
    }
    for kind in ("int8", "fp8"):
        cq, pq = quant[kind], qpools[kind]
        rd = 2 * H2 * (D2 + 4)                # a read column, K and V
        specs[f"decode_attention_quant {kind}"] = (
            lambda cq=cq: attend_cache_quant(q, *cq, pos),
            lambda cq=cq: attend_cache_quant_plain(q, *cq, pos),
            qo + n_cols * rd)
        specs[f"paged_attention_quant {kind}"] = (
            lambda pq=pq: paged_attention_quantized(q, *pq, table, pos),
            lambda pq=pq: paged_attention_quantized_plain(q, *pq, table,
                                                          pos),
            qo + n_cols * rd + 4 * n_tbl)
    rows = {}
    for key, (fn, plain, n_bytes) in specs.items():
        name, _, kind = key.partition(" ")
        out = fn()
        ref = plain()
        torch.cuda.synchronize()
        err = {}
        _hold_read(f"{key} at the 2.7B's decode shape", out, ref, BF16_TOL,
                   err, 0)
        if name.startswith("paged"):
            contig = specs[key.replace("paged_attention", "decode_attention")]
            check(torch.equal(_bits(out), _bits(contig[0]())),
                  f"{key} at the 2.7B's decode shape: not bit-equal to the "
                  f"contiguous read")
        check(torch.equal(_bits(fn()), _bits(out)),
              f"{key} at the 2.7B's decode shape: two launches differ")
        bms, by = bound(n_bytes, 4 * n_cols * H2 * D2, FP32_FLOPS_PER_S)
        r = dict(d=D2, max_abs_err=err[0], ms=time_ms(fn),
                 eager_ms=eager_ms(fn), plain_ms=time_ms(plain),
                 bound_ms=bms, bound_by=by,
                 shape=(f"b={B2} h={H2} S={S2} d={D2}" if "paged" not in name
                        else f"b={B2} h={H2} P={P} pages={N2} "
                        f"max_pages={MP2} d={D2}")
                 + (f" bf16 q, {kind} planes" if kind else " bf16")
                 + f", pos={pos_l}")
        r["library_ms"] = (time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=mask))
            if name == "decode_attention" else None)
        r["split_cols"], r["n_splits"] = read_splits(S2, D2)
        if kind == "fp8":
            rows[name]["fp8"] = r
            continue
        # max|out - plain| at each width: "d dtype" or "d kind q-dtype"
        r["widths"] = {" ".join(str(x).replace("torch.", "")
                                for x in k[1:]): v
                       for k, v in worst.items() if k[0] == name}
        rows[name] = r
    rows.update(_quant_writes_2p7b(g, pos, pos_l, table, (kc, vc),
                                   (kp, vp), quant, qpools))
    for name, r in rows.items():
        log(f"kernel {name} at the 2.7B's decode shape: {r['ms']:.4f} ms "
            f"(eager {r['eager_ms']:.4f}), plain {r['plain_ms']:.4f} ms, "
            f"library {r.get('library_ms')} ms, bound {r['bound_ms']:.5f} "
            f"ms ({r['bound_by']})"
            + (f", its bf16 write {r['bf16_ms']:.4f} ms" if "bf16_ms" in r
               else "")
            + (f"; fp8 {r['fp8']['ms']:.4f} ms, plain "
               f"{r['fp8']['plain_ms']:.4f}" if "fp8" in r else "")
            + f" at {r['shape']}")
    reset_launch_counts()
    return rows


def _quant_write_specs(pos, table, n_rows, d, bf16_caches, bf16_pools,
                       quant_planes, quant_pools, new1, new_t):
    """{kernel name: (the quantized write, its plain twin, its bf16
    counterpart on the bf16 caches (rows 7, 8, 13, 15), bytes moved)} for
    the four quantized writes of one shape: n_rows
    head rows a (row, lane), new1 ``[b, h, d]`` and new_t ``[b, h, T,
    d]`` bf16 rows, the int8 or fp8 planes and pools."""
    from apex_tpu_torch.kernels import (
        cache_write_columns,
        cache_write_columns_quant,
        cache_write_columns_quant_plain,
        paged_write_column,
        paged_write_column_quant,
        paged_write_column_quant_plain,
        paged_write_columns,
        paged_write_columns_quant,
        paged_write_columns_quant_plain,
        write_column,
        write_column_quant,
        write_column_quant_plain,
    )

    B, T = new_t[0].shape[0], new_t[0].shape[2]
    P = quant_pools[0].shape[2]
    S = table.shape[1] * P
    pl = pos.long()
    cols = (pl[:, None] + torch.arange(T, device=pos.device)[None]).clamp(
        max=S - 1)
    distinct = lambda c: B + int((c[:, 1:] != c[:, :-1]).sum())
    # a written cell: its bf16 row read, its byte row and fp32 scale
    # written, for K and V
    cell = 2 * n_rows * (d * 2 + d + 4)
    kn, vn = new1
    knt, vnt = new_t
    kc, vc = bf16_caches
    kp, vp = bf16_pools
    cq, pq = quant_planes, quant_pools
    return {
        "decode_write_column_quant": (
            lambda: write_column_quant(kn, vn, *cq, pos),
            lambda: write_column_quant_plain(kn, vn, *cq, pos),
            lambda: write_column(kn, vn, kc, vc, pos), B * cell + B * 4),
        "cache_write_columns_quant": (
            lambda: cache_write_columns_quant(knt, vnt, *cq, pos),
            lambda: cache_write_columns_quant_plain(knt, vnt, *cq, pos),
            lambda: cache_write_columns(knt, vnt, kc, vc, pos),
            distinct(cols) * cell + B * 4),
        "paged_write_column_quant": (
            lambda: paged_write_column_quant(kn, vn, *pq, table, pos),
            lambda: paged_write_column_quant_plain(kn, vn, *pq, table, pos),
            lambda: paged_write_column(kn, vn, kp, vp, table, pos),
            B * cell + B * 8),
        "paged_write_columns_quant": (
            lambda: paged_write_columns_quant(knt, vnt, *pq, table,
                                                   pos),
            lambda: paged_write_columns_quant_plain(knt, vnt, *pq, table,
                                                    pos),
            lambda: paged_write_columns(knt, vnt, kp, vp, table, pos),
            distinct(cols) * cell + B * 4 + 4 * distinct(cols // P)),
    }


def _quant_writes_2p7b(g, pos, pos_l, table, bf16_caches, bf16_pools, quant,
                       qpools) -> dict:
    """The four quantized writes at the 2.7B's decode shape (b 8, 32 heads
    of 80, horizon 1024, bf16 rows; SPEC_T columns for rows 9 and 16), int8
    planes with fp8 beside: each held bit-equal to its plain twin and
    timed as in phase 3 beside its bf16 counterpart in turns (write, bf16,
    bf16, write; the medians). Returns {kernel name: its 2.7B entry}."""
    B2, H2, D2 = D27_B, D27_H, D27_D
    mk = lambda *shp: torch.randn(*shp, generator=g, device="cuda",
                                  dtype=torch.bfloat16)
    new1 = (mk(B2, H2, D2), mk(B2, H2, D2))
    new_t = (mk(B2, H2, SPEC_T, D2), mk(B2, H2, SPEC_T, D2))
    rows = {}
    for kind in ("int8", "fp8"):
        specs = _quant_write_specs(pos, table, H2, D2, bf16_caches,
                                   bf16_pools, quant[kind], qpools[kind],
                                   new1, new_t)
        for name, (fn, plain, bf16_fn, n_bytes) in specs.items():
            planes = qpools[kind] if "paged" in name else quant[kind]
            a = [x.clone() for x in planes]
            saved = [x.clone() for x in planes]
            fn()
            torch.cuda.synchronize()
            got = [x.clone() for x in planes]
            for x, y in zip(planes, a):
                _bits(x).copy_(_bits(y))
            plain()
            torch.cuda.synchronize()
            check(_same_planes(got, planes), f"{name} {kind} at the 2.7B's "
                  f"decode shape: planes differ from plain (bitwise)")
            for x, y in zip(planes, saved):
                _bits(x).copy_(_bits(y))
            turns = [time_ms(fn), time_ms(bf16_fn), time_ms(bf16_fn),
                     time_ms(fn)]
            bms, by = bound(n_bytes, 0, FP32_FLOPS_PER_S)
            r = dict(d=D2, max_abs_err=0.0, ms=statistics.median(turns[::3]),
                     bf16_ms=statistics.median(turns[1:3]),
                     eager_ms=eager_ms(fn), plain_ms=time_ms(plain),
                     bound_ms=bms, bound_by=by, library_ms=None,
                     shape=(f"b={B2} h={H2} S={D27_S} d={D2}"
                            if "paged" not in name else
                            f"b={B2} h={H2} P={PAGE} max_pages="
                            f"{table.shape[1]} d={D2}")
                     + (f" T={SPEC_T}" if "columns" in name else "")
                     + f" bf16 rows, {kind} planes, pos={pos_l}")
            r["ms / bf16_ms"] = r["ms"] / r["bf16_ms"]
            if kind == "fp8":
                rows[name]["fp8"] = r
            else:
                rows[name] = r
            del a, saved, got
    return rows


# ---------------------------------------------------------------------------
# phase 20: the quantized cache in serving — bench's KV-cache A/B #1 and the
# paged and speculative paths over int8
# ---------------------------------------------------------------------------

#: decode-logit band of a quantized cache against the compute-dtype cache:
#: JAX's _KV_TOL (tests/test_kv_cache.py), the quantization error band
KV_TOL = {"int8": dict(rtol=4e-2, atol=4e-2),
          "fp8": dict(rtol=8e-2, atol=8e-2)}
#: what the shapes alone give (24 layers x K and V x 16 heads x 192
#: columns of 64 values): cache bytes per slot, compute (bf16) and
#: quantized (a byte a value plus an fp32 scale a row), and the pools of
#: 193 pages of 8
KV_BYTES_PER_SLOT = {"compute": 18_874_368, "quant": 10_027_008}
KV_POOL_BYTES = {"compute": 151_781_376, "quant": 80_633_856}


def kv_ab_config(**over):
    """bench.py serve()'s KV-cache A/B #1 geometry: phase 5's engine at
    ``decode_chunk=8``."""
    from apex_tpu_torch.serving import EngineConfig

    return EngineConfig(**{**dict(slots=SLOTS, max_prompt_len=64,
                                  max_seq_len=HORIZON, decode_chunk=8),
                           **over})


def phase_quant_logits(cfg, params, beside_xla=()):
    """Phase 4's prompts and decode steps through the kernels at full
    width with the compute cache, the int8 cache and the fp8 cache, in
    fp32 compute (as JAX's oracle: the band is the quantization's, not
    bf16's rounding): every quantized logit within KV_TOL of the compute
    cache's. The kinds in ``beside_xla`` also run through the "xla" read
    of the same cache (dequantized, then the materialised scores) and are
    held by phase 4's rule instead: the kernel path's error against the
    compute cache at most twice the "xla" path's. KV_TOL is JAX's band
    for its own 2-layer oracle model; it is the cache's rounding, which a
    deeper model carries further (phase 34 holds the 2.7B's fp8 so).
    Returns each kind's max |quantized - compute| through the kernels."""
    import dataclasses

    from apex_tpu_torch.models import gpt

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    lens = [64, 1, 17, 40]
    prompts = np.zeros((4, 64), np.int64)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, cfg.vocab_size, n)
    steps = rng.integers(0, cfg.vocab_size, (8, 4))
    base = dataclasses.replace(cfg, attn_impl="flash",
                               decode_attn_impl="kernel",
                               compute_dtype=torch.float32)
    p = gpt.cast_params(base, params)
    out = {}
    runs = [(kind, "kernel") for kind in ("compute", "int8", "fp8")]
    runs += [(kind, "xla") for kind in beside_xla]
    for kind, impl in runs:
        c = dataclasses.replace(base, kv_cache_dtype=kind,
                                decode_attn_impl=impl)
        cache, lg = gpt.prefill_many(
            c, p, torch.as_tensor(prompts, device=dev),
            torch.as_tensor(lens, device=dev) - 1, max_len=80)
        got = [lg]
        pos = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        for j in range(steps.shape[0]):
            lg, cache = gpt.decode_step(
                c, p, cache, torch.as_tensor(steps[j], device=dev), pos + j)
            got.append(lg)
        out[kind if impl == "kernel" else f"{kind}_xla"] = torch.stack(got)
        del cache
    torch.cuda.synchronize()
    errs = {}
    for kind in ("int8", "fp8"):
        check(bool(torch.isfinite(out[kind]).all()),
              f"quant logits {kind}: non-finite")
        errs[kind] = max_err(out[kind], out["compute"])
        log(f"quant logits {kind}: [9 steps, 4, {cfg.vocab_size}] fp32, "
            f"max|{kind} - compute cache|={errs[kind]:.4f} (band rtol=atol="
            f"{KV_TOL[kind]['rtol']}), logit std "
            f"{float(out['compute'].std()):.3f}")
        if kind in beside_xla:
            err_x = max_err(out[f"{kind}_xla"], out["compute"])
            log(f"quant logits {kind}: through the xla read "
                f"max|{kind} - compute cache|={err_x:.4f}, max|kernel - "
                f"xla|={max_err(out[kind], out[kind + '_xla']):.4f}")
            check(errs[kind] <= 2 * err_x,
                  f"quant logits {kind}: kernel path error {errs[kind]} > "
                  f"2 x xla path error {err_x}")
            continue
        check(close(out[kind], out["compute"], KV_TOL[kind]),
              f"quant logits {kind}: off the compute cache by "
              f"{errs[kind]} (band {KV_TOL[kind]})")
    del p
    torch.cuda.empty_cache()
    return errs


def _drift_gaps(cfg, params, reqs, got, want):
    """Each request whose stream in ``got`` differs from ``want``:
    ``(request, index of the first divergence, the reference forward's
    top-2 gap there)`` (as phase 17 reports them; a sampled request's
    gap is its draw's margin between the two tokens, see
    ``_first_gap``)."""
    gaps = []
    for r in reqs:
        a, b = got[r.request_id], want[r.request_id]
        if a != b:
            k = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            gaps.append((r.request_id, k, _first_gap(
                cfg, params, r, b, k, a[k] if k < len(a) else None)))
    return gaps


def _check_quant_counts(what, counts, on, steps, L):
    """``on`` kernels launched L x ``steps`` times each, every other
    decode kernel (quantized or not, fused or stand-alone) none."""
    decode = ("decode_write_column", "decode_attention", "paged_write_column",
              "paged_attention", "cache_write_columns", "paged_write_columns")
    for name in (decode + tuple(n + "_quant" for n in decode)
                 + ("decode_attention_write", "paged_attention_write",
                    "decode_verify_attention", "paged_verify_attention")):
        want = L * steps if name in on else 0
        check(counts[name] == want and (want > 0 or name not in on),
              f"{what}: {name} launched {counts[name]} times, expected "
              f"{want}")


def phase_quant_serving(cfg, params, band, quant_err):
    """bench's KV-cache A/B #1 on phase 5's trace at ``decode_chunk=8``:
    the int8 cache against the compute cache in turns (int8, compute,
    compute, int8), serial (the port's scheduler has no pipelining; bench
    runs depth 2): cache bytes per slot and their ratio, decode tokens/s,
    each side's idle share (a 3-chunk profiled window), the launch counts
    (the quantized decode kernels on every layer of every step, none of
    the compute cache's). Then the same trace once with fp8, once paged
    (``page_size=8``) int8 (streams identical to contiguous int8), and
    once each with int8 and fp8 through ``decode_attn_impl="xla"`` (the
    plain quantized path): every kernel-side stream identical to it, or
    first diverging at a reference top-2 gap within ``band + 2 x`` the
    kind's phase-20 logit error. Last, phase 17's greedy "high" trace
    with int8 and ``spec_k=3`` against int8 plain under the scheduler
    (tokens per wave, drift with first-divergence gaps), and with every
    chunk speculative through a paged and a contiguous int8 spec engine
    (identical streams)."""
    import dataclasses

    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.serving import Engine

    L = cfg.num_layers
    q_cfg = {k: dataclasses.replace(cfg, kv_cache_dtype=k)
             for k in ("int8", "fp8")}
    sides = {"int8": q_cfg["int8"], "compute": cfg}
    reqs = bench_trace(cfg.vocab_size)
    out = {"decode_tokens_per_sec": {"int8": [], "compute": []}}
    streams, comps, counts_of = {}, {}, {}
    for side in ("int8", "compute", "compute", "int8"):
        engine, sched, wall, counts = serve_timed(
            sides[side], params, kv_ab_config(), bench_trace(cfg.vocab_size))
        s = sched.summary()
        out["decode_tokens_per_sec"][side].append(s["decode_tokens_per_sec"])
        if side in streams:
            del engine, sched
            continue
        check(len(sched.completions) == len(reqs)
              and all(len(sched.completions[r.request_id].tokens)
                      == r.max_tokens for r in reqs),
              f"kv A/B {side}: not every request completed in full")
        steps = engine.decode_steps_taken
        on = (("decode_write_column_quant", "decode_attention_quant")
              if side == "int8" else ("decode_attention_write",))
        _check_quant_counts(f"kv A/B {side}", counts, on, steps, L)
        check(counts["flash_attention_bsh"] == L * engine.admit_groups,
              f"kv A/B {side}: flash prefill launches off the groups")
        check_tc(f"kv A/B {side}", counts, "flash_attention_bsh")
        per_slot = engine.cache_bytes() // engine.slots
        want = KV_BYTES_PER_SLOT["quant" if side == "int8" else "compute"]
        check(per_slot == want, f"kv A/B {side}: {per_slot} cache bytes "
              f"per slot, expected {want}")
        check(s["cache_bytes"] == engine.cache_bytes(),
              f"kv A/B {side}: summary cache_bytes off the engine's")
        prof = phase_profile(cfg, engine, chunks=3)
        out[side] = dict(
            cache_bytes_per_slot=per_slot, wall_s=wall, decode_steps=steps,
            admit_groups=engine.admit_groups,
            device_idle_share=(prof or {}).get("device_idle_share",
                                               "not measured"),
            launches={k: v for k, v in counts.items() if v},
            **{k: s[k] for k in ("tokens_per_sec", "decode_tokens_per_sec",
                                 "ttft_mean_ms")})
        streams[side] = {r: c.tokens for r, c in sched.completions.items()}
        comps[side] = sched.completions
        counts_of[side] = counts
        del engine, sched
    tps = out["decode_tokens_per_sec"]
    out["bytes_ratio"] = round(out["compute"]["cache_bytes_per_slot"]
                               / out["int8"]["cache_bytes_per_slot"], 3)
    out["int8_over_compute_decode"] = sum(tps["int8"]) / sum(tps["compute"])
    out["int8_vs_compute_drift"] = sum(
        streams["int8"][r] != streams["compute"][r] for r in streams["int8"])
    log(f"kv A/B #1: cache bytes per slot compute "
        f"{out['compute']['cache_bytes_per_slot']} vs int8 "
        f"{out['int8']['cache_bytes_per_slot']}, bytes_ratio "
        f"{out['bytes_ratio']}; decode tokens/s in turns int8, compute, "
        f"compute, int8 (serial, depth 1): {json.dumps(tps)}, int8 / "
        f"compute {out['int8_over_compute_decode']:.3f}; idle share int8 "
        f"{out['int8']['device_idle_share']}, compute "
        f"{out['compute']['device_idle_share']}")
    check(out["bytes_ratio"] == 1.882,
          f"kv A/B: bytes_ratio {out['bytes_ratio']} != 1.882")

    # fp8 once; both kinds once through the plain quantized path ("xla")
    for kind, impl in (("fp8", "kernel"), ("int8", "xla"), ("fp8", "xla")):
        c = dataclasses.replace(q_cfg[kind], decode_attn_impl=impl)
        engine, sched, wall, counts = serve_timed(
            c, params, kv_ab_config(), bench_trace(cfg.vocab_size))
        check(len(sched.completions) == len(reqs),
              f"kv {kind} {impl}: not every request completed")
        key = kind if impl == "kernel" else f"{kind}_xla"
        streams[key] = {r: c_.tokens for r, c_ in sched.completions.items()}
        comps[key] = sched.completions
        if impl == "kernel":
            _check_quant_counts(
                f"kv {kind}", counts, ("decode_write_column_quant",
                                       "decode_attention_quant"),
                engine.decode_steps_taken, L)
            check(engine.cache_bytes() // engine.slots
                  == KV_BYTES_PER_SLOT["quant"],
                  f"kv fp8: {engine.cache_bytes()} cache bytes")
            out["fp8"] = dict(
                wall_s=wall, decode_tokens_per_sec=sched.summary()[
                    "decode_tokens_per_sec"],
                cache_bytes_per_slot=engine.cache_bytes() // engine.slots)
        else:
            _check_quant_counts(f"kv {kind} xla", counts, (), 0, L)
        del engine, sched
    for kind in ("int8", "fp8"):
        lim = band + 2 * quant_err[kind]
        gaps = _drift_gaps(cfg, params, reqs, streams[kind],
                           streams[f"{kind}_xla"])
        held = {side: hold_streams(cfg, params, reqs, comps[side])
                for side in (kind, f"{kind}_xla")}
        out[f"{kind}_kernel_vs_xla"] = dict(
            drift=len(gaps), first_divergence_gaps=gaps, band=lim,
            max_logprob_err={k_: v[0] for k_, v in held.items()},
            greedy_gap={k_: v[1] for k_, v in held.items()})
        log(f"kv {kind}: kernel vs xla streams, {len(gaps)} of {len(reqs)} "
            f"drift; first divergences (request, index, gap): {gaps}; "
            f"against the reference forward, max|logprob-ref| and greedy "
            f"gap kernel {held[kind]}, xla {held[kind + '_xla']} (band "
            f"{lim:.4f})")
        check(all(g <= lim for _, _, g in gaps),
              f"kv {kind}: a kernel-side stream leaves the xla path at a "
              f"gap above {lim}: {gaps}")
        check(all(v <= lim for hv in held.values() for v in hv),
              f"kv {kind}: streams off the reference by {held} (band "
              f"{lim})")

    # paged int8: the same trace, streams identical to contiguous int8
    engine, sched, wall, counts = serve_timed(
        q_cfg["int8"], params, kv_ab_config(page_size=PAGE),
        bench_trace(cfg.vocab_size))
    paged_streams = {r: c.tokens for r, c in sched.completions.items()}
    drift = [r for r in streams["int8"]
             if paged_streams.get(r) != streams["int8"][r]]
    check(not drift, f"kv paged int8: streams differ from contiguous int8 "
          f"for {drift}")
    _check_quant_counts("kv paged int8", counts,
                        ("paged_write_column_quant", "paged_attention_quant"),
                        engine.decode_steps_taken, L)
    check(engine.cache_bytes() == KV_POOL_BYTES["quant"],
          f"kv paged int8: pool of {engine.cache_bytes()} bytes")
    counts_of["paged"] = counts
    out["paged_int8"] = dict(
        wall_s=wall, pool_bytes=engine.cache_bytes(),
        decode_tokens_per_sec=sched.summary()["decode_tokens_per_sec"])
    del engine, sched
    engine = Engine(cfg, params, kv_ab_config(page_size=PAGE))
    out["paged_compute_pool_bytes"] = engine.cache_bytes()
    check(engine.cache_bytes() == KV_POOL_BYTES["compute"],
          f"kv paged compute: pool of {engine.cache_bytes()} bytes")
    del engine
    log(f"kv paged int8: 32 streams identical to contiguous int8; pool "
        f"{out['paged_int8']['pool_bytes']} bytes against "
        f"{out['paged_compute_pool_bytes']} (compute)")

    # speculative int8: phase 17's "high" trace, spec_k=3 vs plain
    spec_reqs = spec_trace(cfg.vocab_size, False)
    spec_streams = {}
    for side in ("spec", "plain"):
        engine, sched, wall, counts = serve_timed(
            q_cfg["int8"], params,
            spec_config() if side == "spec" else spec_config(spec_k=0),
            spec_trace(cfg.vocab_size, False))
        check(len(sched.completions) == len(spec_reqs),
              f"kv spec int8 {side}: not every request completed")
        s = sched.summary()
        spec_streams[side] = {r: c.tokens
                              for r, c in sched.completions.items()}
        row = dict(wall_s=wall, decode_tokens_per_sec=s[
            "decode_tokens_per_sec"], verify_waves=engine.spec_waves_taken,
                   decode_steps=engine.decode_steps_taken)
        if side == "spec":
            waves = engine.spec_waves_taken
            check(counts["cache_write_columns_quant"] == L * waves > 0
                  and counts["cache_write_columns"] == 0
                  and counts["decode_verify_attention"] == 0,
                  f"kv spec int8: cache_write_columns_quant launched "
                  f"{counts['cache_write_columns_quant']} times, expected "
                  f"{L} x {waves} waves")
            counts_of["spec"] = counts
            row.update({k: s[k] for k in ("spec_tokens_per_wave",
                                          "spec_accept_rate",
                                          "spec_gate_state")})
        out[f"spec_int8_{side}"] = row
        del engine, sched
    gaps = _drift_gaps(cfg, params, spec_reqs, spec_streams["spec"],
                       spec_streams["plain"])
    out["spec_int8_drift"] = dict(drift=len(gaps), first_divergence_gaps=gaps)
    log(f"kv spec int8: spec {json.dumps(out['spec_int8_spec'])}, plain "
        f"{json.dumps(out['spec_int8_plain'])}; drift {len(gaps)} of 16, "
        f"first divergences {gaps}")

    # paged + speculative int8, every chunk speculative
    res = {}
    for name, ecfg in (("paged", spec_config(page_size=PAGE)),
                       ("contig", spec_config())):
        engine = Engine(q_cfg["int8"], params, ecfg)
        torch.cuda.synchronize()
        reset_launch_counts()
        toks = drive_spec(engine, spec_reqs)
        torch.cuda.synchronize()
        counts = launch_counts()
        waves = engine.spec_waves_taken
        on = ("paged_write_columns_quant" if name == "paged"
              else "cache_write_columns_quant")
        check(counts[on] == L * waves > 0
              and counts["decode_verify_attention"] == 0
              and counts["paged_verify_attention"] == 0,
              f"kv paged+spec int8 {name}: {on} launched {counts[on]} "
              f"times, expected {L} x {waves} waves (a verify launch ran: "
              f"{counts['decode_verify_attention']} / "
              f"{counts['paged_verify_attention']})")
        res[name] = toks
        if name == "paged":
            counts_of["paged_spec"] = counts
        del engine
    drift = [r for r in res["paged"] if res["paged"][r] != res["contig"][r]]
    check(not drift, f"kv paged+spec int8: streams differ from contiguous "
          f"for {drift}")
    log("kv paged+spec int8: 16 streams identical to contiguous int8 spec")
    launches = {
        "decode_write_column_quant": counts_of["int8"][
            "decode_write_column_quant"],
        "decode_attention_quant": counts_of["int8"]["decode_attention_quant"],
        "paged_write_column_quant": counts_of["paged"][
            "paged_write_column_quant"],
        "paged_attention_quant": counts_of["paged"]["paged_attention_quant"],
        "cache_write_columns_quant": counts_of["spec"][
            "cache_write_columns_quant"],
        "paged_write_columns_quant": counts_of["paged_spec"][
            "paged_write_columns_quant"],
    }
    log("kv serving: " + json.dumps(out))
    return launches, out


# ---------------------------------------------------------------------------
# phase 7: the training path's kernels vs plain, at its shapes
# ---------------------------------------------------------------------------

def _heads_delta(out, do):
    """``delta = sum_d(out * do)`` per head, fp32 ``[b, heads, s]`` (what
    the flash backward's autograd formula hands the backward op)."""
    b, s, _ = out.shape
    return (out.float() * do.float()).view(b, s, HEADS, HEAD_DIM).sum(
        -1).transpose(1, 2).contiguous()


def phase_train_kernels(cfg):
    """The flash forward and backward and ``adam_flat`` against their
    plain versions on the card, at the train step's shapes, with timings.
    Returns ``{name: row}`` for the two new kernels and the forward's
    training-shape numbers."""
    from apex_tpu_torch.kernels import (
        adam_flat,
        adam_flat_plain,
        flash_attention_bsh_bwd,
        flash_attention_bsh_bwd_plain,
        flash_attention_bsh_fwd,
        flash_attention_bsh_plain,
        launch_counts,
        reset_launch_counts,
    )
    from apex_tpu_torch.kernels.flat_ops import adam_scalars
    from apex_tpu_torch.multi_tensor import pad_to

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    rows = {}

    def inputs(b, s, dtype, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(b, s, HIDDEN, generator=g, device=dev,
                            dtype=dtype) for _ in range(4)]

    def bwd_both(q, k, v, do):
        out, lse = flash_attention_bsh_fwd(q, k, v, num_heads=HEADS,
                                           causal=True)
        delta = _heads_delta(out, do)
        got = flash_attention_bsh_bwd(q, k, v, do, lse, delta,
                                      num_heads=HEADS, causal=True)
        want = flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta,
                                             num_heads=HEADS, causal=True)
        torch.cuda.synchronize()
        return got, want, (lse, delta)

    # -- backward at small shapes (s not a multiple of the 64-row tile),
    #    and in fp32 at the train step's sequence length (16 key tiles):
    #    bf16 on the tensor-core kernel (BWD_TC_TOL), with the CUDA-core
    #    bf16 kernel measured on the same inputs; fp32 on the CUDA cores
    worst_small = {}
    seen = {}
    for dtype in (torch.float32, bf16):
        worst = 0.0
        shapes = ((1, 8), (2, 96), (2, 200), (1, 256))
        if dtype == torch.float32:
            shapes += ((2, TRAIN_SEQ),)
        for b, s in shapes:
            tag = f"flash bwd {dtype} b={b} s={s}"
            q, k, v, do = inputs(b, s, dtype, seed=b * s)
            reset_launch_counts()
            got, want, (lse, delta) = bwd_both(q, k, v, do)
            check_tc(tag, launch_counts(), "flash_attention_bsh_bwd",
                     want=int(dtype == bf16))
            if dtype == bf16:
                hold_bwd_tc(tag, got, want, seen)
                _, cc = bsh_bwd_cuda_core(q, k, v, do, lse, delta, HEADS,
                                          True)
                torch.cuda.synchronize()
                hold_bwd_tc(tag, cc, want, seen, side="cuda_core")
            for name, a, w in zip(("dq", "dk", "dv"), got, want):
                check(bool(torch.isfinite(a).all()),
                      f"{tag}: non-finite {name}")
                if dtype == torch.float32:
                    check(close(a, w, FP32_TOL), f"{tag}: {name} err "
                          f"{max_err(a, w)}")
                worst = max(worst, max_err(a, w))
        worst_small[str(dtype).replace("torch.", "")] = worst
    log(f"flash_attention_bsh_bwd at s in 8, 96, 200, 256 (and fp32 b=2 "
        f"s={TRAIN_SEQ}): max|grad-plain| {worst_small}; bf16 against the "
        f"rounding twins, worst (atol_rel, rms): tensor cores {seen['tc']}, "
        f"CUDA cores {seen['cuda_core']} (BWD_TC_TOL {BWD_TC_TOL})")

    # -- the train step's shape: forward, then backward
    b, s = TRAIN_BATCH, TRAIN_SEQ
    q, k, v, do = inputs(b, s, bf16, seed=17)
    reset_launch_counts()
    out, lse = flash_attention_bsh_fwd(q, k, v, num_heads=HEADS, causal=True)
    check_tc(f"flash fwd b={b} s={s}", launch_counts(),
             "flash_attention_bsh", want=1)
    ref, ref_lse = flash_attention_bsh_plain(q, k, v, num_heads=HEADS,
                                             causal=True)
    torch.cuda.synchronize()
    check(close(out, ref, TC_TOL) and close(lse, ref_lse, FP32_TOL),
          f"flash fwd b={b} s={s}: out err {max_err(out, ref)}, lse err "
          f"{max_err(lse, ref_lse)}")
    fwd_err = max_err(out, ref)
    fwd_lse_err = max_err(lse, ref_lse)
    del ref, ref_lse
    reset_launch_counts()
    got, want, (lse, delta) = bwd_both(q, k, v, do)
    check_tc(f"flash bwd b={b} s={s}", launch_counts(),
             "flash_attention_bsh_bwd", want=1)
    errs = [max_err(a, w) for a, w in zip(got, want)]
    step = {}
    hold_bwd_tc(f"flash bwd b={b} s={s}", got, want, step)
    cc_launch, cc = bsh_bwd_cuda_core(q, k, v, do, lse, delta, HEADS, True)
    torch.cuda.synchronize()
    hold_bwd_tc(f"flash bwd b={b} s={s}", cc, want, step, side="cuda_core")
    check_cc_fails(f"flash bwd b={b} s={s}", cc, want)
    del got, want, cc
    log(f"flash at b={b} s={s} bf16: fwd max|out-plain|={fwd_err:.3e}; "
        f"bwd max|dq,dk,dv - plain|={errs}; (atol_rel, rms) against the "
        f"rounding twin: tensor cores {step['tc']}, CUDA cores "
        f"{step['cuda_core']} (BWD_TC_TOL {BWD_TC_TOL})")

    hd = lambda t: t.view(b, s, HEADS, HEAD_DIM).transpose(1, 2)
    qh, kh, vh = (hd(t).detach().requires_grad_(True) for t in (q, k, v))
    fa = lambda: flash_attention_bsh_fwd(q, k, v, num_heads=HEADS,
                                         causal=True)
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     is_causal=True)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        torch.autograd.grad(o, (qh, kh, vh), hd(do))

    pairs = b * HEADS * s * (s + 1) / 2          # causal (row, key) pairs
    act = b * s * HIDDEN * 2                     # one bf16 [b, s, hidden]
    stats = b * HEADS * s * 4                    # one fp32 [b, heads, s]
    fb, fby = bound(4 * act + stats, 4 * HEAD_DIM * pairs)
    fwd_train = dict(
        ms=time_ms(fa, **TRAIN_TIMING), eager_ms=eager_ms(fa, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_plain(
            q, k, v, num_heads=HEADS, causal=True), **TRAIN_TIMING),
        library_ms=time_ms(lib_fwd, **TRAIN_TIMING), bound_ms=fb,
        bound_by=fby, max_abs_err=fwd_err, max_lse_err=fwd_lse_err,
        shape=f"b={b} s={s} hidden={HIDDEN} heads={HEADS} bf16 causal")
    # five products over the causal pairs: S, dP, dV, dK, dQ
    bb, bby = bound(7 * act + 2 * stats, 5 * 2 * HEAD_DIM * pairs)
    fbwd = lambda: flash_attention_bsh_bwd(q, k, v, do, lse, delta,
                                           num_heads=HEADS, causal=True)
    lib_fwd_ms = fwd_train["library_ms"]
    rows["flash_attention_bsh_bwd"] = dict(
        name="flash_attention_bsh_bwd", route="cuda",
        source="apex_tpu_torch/csrc/flash_bwd_tc.cu",
        replaces="apex_tpu/kernels/flash_attention.py:1060",
        variant=TC_BWD_VARIANT["flash_attention_bsh_bwd"],
        max_abs_err=max(errs + list(worst_small.values())),
        ms=time_ms(fbwd, **TRAIN_TIMING),
        eager_ms=eager_ms(fbwd, **TRAIN_TIMING),
        prev_ms=time_ms(cc_launch, **TRAIN_TIMING),
        prev_ms_source="measured in this run: csrc/flash_attention_bsh_bwd"
                       ".cu's bf16 kernel on the same inputs",
        plain_ms=time_ms(lambda: flash_attention_bsh_bwd_plain(
            q, k, v, do, lse, delta, num_heads=HEADS, causal=True),
            **TRAIN_TIMING),
        bound_ms=bb, bound_by=bby,
        library_ms=time_ms(lib_fwd_bwd, **TRAIN_TIMING) - lib_fwd_ms,
        tol=dict(BWD_TC_TOL, tc=seen["tc"], cuda_core=seen["cuda_core"],
                 step_tc=step["tc"], step_cuda_core=step["cuda_core"]),
        shape=fwd_train["shape"])
    del cc_launch
    del q, k, v, do, qh, kh, vh, lse, delta

    # -- adam_flat: a small bf16 group (with skip), then the 355M group
    g = torch.Generator(device=dev).manual_seed(23)
    hp = dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3,
              grad_scale=0.5)
    scalars = adam_scalars(*hp.values(), dev)

    def group(n, p_dtype):
        p = (torch.randn(n, generator=g, device=dev) * 0.02).to(p_dtype)
        gr = torch.randn(n, generator=g, device=dev) * 1e-3
        m = torch.randn(n, generator=g, device=dev) * 1e-3
        v = torch.rand(n, generator=g, device=dev) * 1e-6
        return p, gr, m, v

    def adam_both(p, gr, m, v, **flags):
        pk, mk, vk, pp, mp, vp = (t.clone() for t in (p, m, v, p, m, v))
        adam_flat([pk], [gr], [mk], [vk], **hp, **flags)
        adam_flat_plain([pp], [gr], [mp], [vp], scalars, **flags)
        torch.cuda.synchronize()
        return (pk, mk, vk), (pp, mp, vp)

    p, gr, m, v = group(4 * 65536, bf16)
    (pk, mk, vk), (pp, mp, vp) = adam_both(p, gr, m, v)
    # both sides round the same fp32 result once: one bf16 ulp
    check(ulp_close(pk, pp) and close(mk, mp, ADAM_TOL)
          and close(vk, vp, ADAM_TOL),
          f"adam_flat bf16 params: errs {max_err(pk, pp)}, "
          f"{max_err(mk, mp)}, {max_err(vk, vp)}")
    before = [t.clone() for t in (pk, mk, vk)]
    adam_flat([pk], [gr], [mk], [vk], **hp,
              skip=torch.ones((), dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip((pk, mk, vk), before)),
          "adam_flat: skip=True changed a buffer")
    # the options the train step leaves at their defaults
    for flags in (dict(grad_averaging=False),
                  dict(adam_w_mode=False, out_is_delta=True)):
        got, want = adam_both(*group(4 * 65536, torch.float32), **flags)
        check(all(close(a, w, ADAM_TOL) for a, w in zip(got, want)),
              f"adam_flat {flags}: errs "
              f"{[max_err(a, w) for a, w in zip(got, want)]}")

    n = pad_to(cfg.param_count())
    p, gr, m, v = group(n, torch.float32)
    (pk, mk, vk), (pp, mp, vp) = adam_both(p, gr, m, v)
    adam_errs = [max_err(a, w) for a, w in ((pk, pp), (mk, mp), (vk, vp))]
    check(close(pk, pp, ADAM_TOL) and close(mk, mp, ADAM_TOL)
          and close(vk, vp, ADAM_TOL), f"adam_flat n={n}: errs {adam_errs}")
    log(f"adam_flat n={n} fp32: max|p,m,v - plain|={adam_errs} (tol "
        f"atol=1e-6 rtol=1e-5); bf16 group, skip, grad_averaging=False "
        f"and L2 mode with out_is_delta ok")
    del pp, mp, vp, before
    step_k = lambda: adam_flat([pk], [gr], [mk], [vk], **hp)
    # AdamW's fused step on one flat parameter holding the same values
    w = torch.nn.Parameter(p.clone())
    w.grad = gr.clone()
    lib = torch.optim.AdamW([w], lr=1e-4, weight_decay=0.01, fused=True)
    # per element: read p, g, m, v and write p, m, v (fp32); ~17 flops
    ab, aby = bound(28 * n, 17 * n, FP32_FLOPS_PER_S)
    rows["adam_flat"] = dict(
        name="adam_flat", route="cuda",
        source="apex_tpu_torch/csrc/flat_ops.cu",
        replaces="apex_tpu/kernels/flat_ops.py:260",
        max_abs_err=max(adam_errs),
        ms=time_ms(step_k, **TRAIN_TIMING),
        eager_ms=eager_ms(step_k, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: adam_flat_plain(
            [p], [gr], [m], [v], scalars), **TRAIN_TIMING),
        bound_ms=ab, bound_by=aby,
        library_ms=eager_ms(lib.step, **TRAIN_TIMING),
        shape=f"one fp32 group of n={n} (355M params, padded)")
    del p, gr, m, v, pk, mk, vk, w, lib
    log(f"kernel flash_attention_bsh (train, tensor cores): "
        f"{fwd_train['ms']:.4f} ms; max|out-plain| {fwd_err:.3e}, "
        f"max|lse-plain| {fwd_lse_err:.3e}")
    for r in list(rows.values()) + [dict(fwd_train, name="flash_attention_"
                                                          "bsh (train)")]:
        prev = (f", the CUDA-core kernel {r['prev_ms']:.4f} ms"
                if "prev_ms" in r else "")
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms){prev}, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}) at {r['shape']}")
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows, fwd_train


# ---------------------------------------------------------------------------
# phase 8: gradients at 355M width, kernels vs the materialised scores
# ---------------------------------------------------------------------------

def _loss_grads(loss_fn, params):
    """``(loss, fp32 gradients in leaf order)`` of ``loss_fn(params)``."""
    from apex_tpu_torch import _tree

    leaves, spec = _tree.flatten(params)
    diff = [x.detach().requires_grad_(True) for x in leaves]
    loss = loss_fn(_tree.unflatten(spec, diff))
    grads = torch.autograd.grad(loss, diff)
    return float(loss.detach()), [g_.float() for g_ in grads]


def _hold_grads(what, got):
    """Errors of the "kernel" and bf16 "xla" paths' gradients in ``got``
    (``{path: (loss, grads)}``) against the "fp32" path's: the largest
    absolute difference over every element, and the relative L2 norm of
    the difference over all gradients. The band: each of the kernel
    path's at most 3x the bf16 "xla" path's."""
    ref = got["fp32"][1]
    norm = float(torch.sqrt(sum((r_ * r_).sum() for r_ in ref)))

    def errs(gs):
        mx = max(max_err(a, r_) for a, r_ in zip(gs, ref))
        l2 = float(torch.sqrt(sum(((a - r_) ** 2).sum()
                                  for a, r_ in zip(gs, ref)))) / norm
        return mx, l2

    (k_mx, k_l2), (x_mx, x_l2) = errs(got["kernel"][1]), errs(got["xla"][1])
    losses = {name: v[0] for name, v in got.items()}
    log(f"{what}: losses {losses}; vs fp32: kernel max {k_mx:.4e} relL2 "
        f"{k_l2:.4e}, bf16 xla max {x_mx:.4e} relL2 {x_l2:.4e}; fp32 grad "
        f"norm {norm:.4f}")
    for name, (_, gs) in got.items():
        check(all(bool(torch.isfinite(g_).all()) for g_ in gs),
              f"{what} {name}: non-finite")
    check(k_mx <= 3 * x_mx, f"{what}: kernel max err {k_mx} > 3 x xla {x_mx}")
    check(k_l2 <= 3 * x_l2, f"{what}: kernel relL2 {k_l2} > 3 x xla {x_l2}")
    return dict(kernel_max=k_mx, kernel_rel_l2=k_l2, xla_max=x_mx,
                xla_rel_l2=x_l2)


def phase_grads(cfg, params, tok, tgt):
    """One gradient of the loss on the batch's first 4 rows through the
    kernels (bf16, the train step's remat policy), the "xla" attention in
    bf16 and the "xla" attention in fp32 (the reference), on the same
    weights, held by :func:`_hold_grads`."""
    import dataclasses

    from apex_tpu_torch.models import gpt

    xla = dict(attn_impl="xla", remat_policy="qkv_fc1")
    paths = {"kernel": cfg, "xla": dataclasses.replace(cfg, **xla),
             "fp32": dataclasses.replace(cfg, **xla,
                                         compute_dtype=torch.float32)}
    torch.backends.cuda.matmul.allow_tf32 = False
    tok, tgt = tok[:4], tgt[:4]
    got = {name: _loss_grads(lambda p, c=c: gpt.loss(c, p, tok, tgt), params)
           for name, c in paths.items()}
    return _hold_grads("grads at 355M, batch 4", got)


# ---------------------------------------------------------------------------
# phase 9: the train step; phase 10: where its time goes
# ---------------------------------------------------------------------------

def train_config():
    """bench.py main()'s on-chip configuration: GPT-2 355M with selective
    remat (``qkv_fc1_attn``), chunked cross entropy, bf16, flash."""
    from apex_tpu_torch.models import gpt

    return gpt.GPTConfig(
        vocab_size=50304, hidden_size=1024, num_layers=24, num_heads=16,
        seq_len=1024, remat=True, ce_chunk=512, compute_dtype=torch.bfloat16,
        attn_impl="flash", ln_impl="xla", remat_policy="qkv_fc1_attn")


def train_batch(cfg):
    """bench.py main()'s fixed batch, regenerated with numpy: uniform token
    ids of seed 1, targets rolled by one."""
    tok = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.seq_len)), device="cuda")
    return tok, torch.roll(tok, -1, 1)


def phase_train(cfg, layout, tok, tgt):
    """``make_train_step`` with ``fused_adam(1e-4, layout=layout)`` and
    the identity scaler: one warm-up step and ``TRAIN_STEPS`` timed ones,
    weights from seed 0, launch counts zeroed just before and read just
    after. Returns (metrics, state, step_fn)."""
    from apex_tpu_torch.amp import ScalerConfig
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import make_train_step
    from apex_tpu_torch.optimizers import fused_adam

    init_fn, step_fn = make_train_step(cfg, fused_adam(1e-4, layout=layout),
                                       ScalerConfig(enabled=False))
    state = init_fn(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step_fn(state, tok, tgt)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, tok, tgt)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in losses]
    n_steps = TRAIN_STEPS + 1
    L = cfg.num_layers
    metrics = dict(
        layout=layout,
        train_tokens_per_sec=TRAIN_STEPS * tok.numel() / wall,
        step_ms=wall / TRAIN_STEPS * 1e3, warmup_step_ms=warm * 1e3,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        losses=losses, launches=counts,
        launches_per_step={k: v / n_steps for k, v in counts.items()})
    log(f"train {layout}: " + json.dumps(metrics))
    check(all(np.isfinite(losses)), f"train {layout}: non-finite loss")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"train {layout}: first loss {losses[0]} is not near ln(vocab) "
          f"{math.log(cfg.vocab_size):.3f}")
    check(losses[-1] < losses[0] - 0.1,
          f"train {layout}: the loss did not fall on the repeated batch")
    want_adam = n_steps if layout == "flat" else 0
    check(counts["flash_attention_bsh"] == L * n_steps,
          f"train {layout}: flash forward launched "
          f"{counts['flash_attention_bsh']} times, expected {L} x {n_steps}"
          f" (twice that means the backward replayed it)")
    check_tc(f"train {layout}", counts, "flash_attention_bsh")
    check_tc(f"train {layout} backward", counts, "flash_attention_bsh_bwd")
    check(counts["flash_attention_bsh_bwd"] == L * n_steps,
          f"train {layout}: flash backward launched "
          f"{counts['flash_attention_bsh_bwd']} times, expected {L} x "
          f"{n_steps}")
    check(counts["adam_flat"] == want_adam,
          f"train {layout}: adam_flat launched {counts['adam_flat']} times, "
          f"expected {want_adam}")
    # the fused CE: per chunk the forward twice (the chunk checkpoint
    # replays it in the backward) and the backward once
    chunks = cfg.seq_len // cfg.ce_chunk if cfg.ce_chunk else 1
    fused = cfg.ce_impl == "fused"
    want_xent = {"xentropy_fwd": (2 if cfg.ce_chunk else 1) * chunks,
                 "xentropy_bwd": chunks}
    for name, per_step in want_xent.items():
        want = per_step * n_steps if fused else 0
        check(counts[name] == want, f"train {layout}: {name} launched "
              f"{counts[name]} times, expected {want}")
    return metrics, state, step_fn


#: kernel-name fragments → the category a train step's device time is
#: summed under (first match wins; the rest is "other")
KERNEL_CATEGORIES = (
    ("flash_fwd_tc", ("flash_fwd_tc",)),
    ("flash_bwd_tc", ("flash_bwd_tc", "flash_bwd_dq_tc")),
    ("flash_fwd_hm", ("flash_fwd_hm",)),
    ("flash_bwd_hm", ("flash_bwd_kv_hm", "flash_bwd_dq_hm")),
    ("flash_fwd", ("flash_fwd_bsh",)), ("flash_bwd", ("flash_bwd_",)),
    ("adam_flat", ("adam_kernel",)),
    ("layer_norm", ("ln_fwd_kernel", "ln_bwd_")),
    ("l2norm_flat", ("l2norm_kernel",)),
    ("gemm", ("nvjet", "gemm", "cutlass", "xmma")),
    ("concat (packing, unbind backward)", ("CatArrayBatchedCopy",)),
    ("reduction", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)))


def phase_train_profile(layout, state, step_fn, batch, steps: int = 2):
    """``torch.profiler`` over ``steps`` train steps: the device's busy
    share, its time per step by kernel category and by kernel, and the
    device time of the flat optimizer's packing (its ``fused_adam.pack``
    or ``fused_lamb.pack`` range). A measurement, not a check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step_fn(state, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    events = [e for e in avgs if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    if not events:
        log("train profile: device time not measured (the profiler saw no "
            "kernel)")
        return None
    busy_us = sum(e.self_device_time_total for e in events)
    per_step = {}
    for e in events:
        cat = next((c for c, keys in KERNEL_CATEGORIES
                    if any(k in e.key for k in keys)), "other")
        per_step[cat] = (per_step.get(cat, 0.0)
                         + e.self_device_time_total / 1e3 / steps)
    pack = [e for e in avgs if e.key.endswith(".pack")]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    out = {
        "layout": layout, "window_steps": steps, "wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1 - busy_us / 1e3 / (wall * 1e3)),
        "device_ms_per_step_by_category": per_step,
        "pack_device_ms_per_step": (
            pack[0].device_time_total / 1e3 / steps if pack
            else "not measured"),
        "top": [{"name": e.key[:60], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top],
    }
    log("train profile: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 11: the BERT path's kernels vs plain, at its shapes
# ---------------------------------------------------------------------------

def bert_config(**over):
    """BERT-large as ``BertConfig()`` has it (vocab 30528, hidden 1024, 24
    layers of 16 heads, seq 512, full remat, bf16 compute, fp32 params);
    ``over`` picks the run."""
    from apex_tpu_torch.models import bert

    return bert.BertConfig(**over)


def bert_batch(cfg):
    """``examples/bert_pretrain.py``'s MLM batch at batch 32: uniform
    tokens from ``RandomState(0)``, ``mlm_mask = rand < 0.15``, targets
    the tokens themselves."""
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (BERT_BATCH, cfg.seq_len))
    mask = (rng.rand(BERT_BATCH, cfg.seq_len) < 0.15).astype(np.int32)
    tok_t = torch.as_tensor(tok, device="cuda")
    return tok_t, tok_t, torch.as_tensor(mask, device="cuda")


def _ln_rows(dev, rows, hidden, dtype, w_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shp, dt=torch.float32: torch.randn(
        *shp, generator=g, device=dev).to(dt)
    x = (mk(rows, hidden) * 2 + 0.5).to(dtype)
    return x, mk(hidden, dt=w_dtype), mk(hidden, dt=w_dtype), mk(
        rows, hidden, dt=dtype)


#: the LayerNorm backward's route-1 widths held in phase 11 beside the
#: step's [16384, 1024] (bf16 with fp32 w, and fp32: the fp16 amp path),
#: one for every other chunk count NC (hidden = NC x 32 x the values of a
#: 16-byte vector: NC 1, 2, 8 in bf16; 1, 2, 4 in fp32), fp32 w
LN_NC_SHAPES = ((4096, 256, torch.bfloat16), (4096, 512, torch.bfloat16),
                (4096, 2048, torch.bfloat16), (4096, 128, torch.float32),
                (4096, 256, torch.float32), (4096, 512, torch.float32))


@contextlib.contextmanager
def ln_bwd_routes():
    """The routes ``layer_norm_bwd`` launches while the block runs, in
    order (``kernels/layer_norm.py:bwd_geometry`` wrapped by a
    recorder)."""
    # the module (the package re-exports a function of its name)
    ln = importlib.import_module("apex_tpu_torch.kernels.layer_norm")
    seen, real = [], ln.bwd_geometry

    def record(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[0])
        return out
    ln.bwd_geometry = record
    try:
        yield seen
    finally:
        ln.bwd_geometry = real


def ln_bwd_on_route(x, w, mean, rstd, dy, sub: bool, route: int):
    """``csrc/layer_norm.cu``'s backward on ``route`` (1: the row and the
    partials in registers, 0: the earlier design), launched directly with
    that route's geometry: ``(launch, (dx, dw, db))``. Its launches are not
    counted."""
    from apex_tpu_torch.kernels import _build
    from apex_tpu_torch.kernels.layer_norm import bwd_geometry

    rows, hidden = x.shape
    _, nblk = bwd_geometry(rows, hidden, x.dtype, route=route)
    f32 = dict(dtype=torch.float32, device=x.device)
    work = torch.empty((nblk, 2, hidden), **f32)
    out = (torch.empty_like(x), torch.empty(hidden, **f32),
           torch.empty(hidden, **f32))

    def launch():
        _build.check(_build.library().apex_tpu_torch_layer_norm_bwd(
            x.data_ptr(), w.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            dy.data_ptr(), *(t.data_ptr() for t in out), work.data_ptr(),
            rows, hidden, int(sub), _build.DTYPE_CODES[x.dtype],
            _build.DTYPE_CODES[w.dtype], route, nblk, _build.stream()),
            f"layer_norm_bwd route {route}")
    launch()
    return launch, out


def device_ops(fn, calls: int = 4, tries: int = 4,
               margin_s: float = 0.25) -> dict:
    """The device work of one call of ``fn`` by ``torch.profiler``:
    ``{name: (launches a call, device us a call)}``, kernels and memsets
    alike, over a window of ``calls`` calls after a warm-up call. Soon
    after the train profiles in this process, windows of a few
    milliseconds and of 1 s kept no device record, where the profiles'
    own windows keep theirs and a 4 s one kept them: so the window stays
    open ``margin_s`` before the first call and after the device has
    finished the last, and a window in which the profiler saw no device
    work is taken again with a margin 4 times as wide, up to ``tries``
    times; ``{}`` means it never saw any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(margin_s * 4 ** attempt)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin_s * 4 ** attempt)
        ops = {e.key: (e.count / calls, e.self_device_time_total / calls)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not e.key.startswith("ProfilerStep")}
        if ops:
            return ops
        log(f"profiler: no device work seen in window {attempt + 1} of "
            f"{tries} (margin {margin_s * 4 ** attempt} s)")
    return {}


def l2_tails(dev):
    """``l2norm_flat``'s tail shapes on the card, each against the plain
    twin: fp32 and bf16 at n = 1, 7, 4097, one tile - 4 and + 4 (a tile:
    ``_build.L2NORM_UNROLL`` 16-byte vectors of each of the block's
    threads) and 9,000,007 (several tiles a block, the last range cut
    mid-tile), five mixed buffers in one launch, and 37 buffers (two
    launches, the first without the finish). Returns the worst relative
    error."""
    from apex_tpu_torch.kernels import _build, l2norm_flat, l2norm_flat_plain

    g = torch.Generator(device=dev).manual_seed(41)
    mk = lambda n, dt: (torch.randn(n, generator=g, device=dev)
                        * 0.5).to(dt)
    worst = 0.0

    def hold(what, bufs):
        nonlocal worst
        got, want = l2norm_flat(bufs), l2norm_flat_plain(bufs)
        torch.cuda.synchronize()
        rel = abs(float(got) - float(want)) / float(want)
        check(close(got, want, dict(atol=0.0, rtol=1e-4)),
              f"l2norm_flat {what}: {float(got)} vs plain {float(want)}")
        worst = max(worst, rel)

    for dt in (torch.float32, torch.bfloat16):
        tile = (_build.L2NORM_UNROLL * (16 // dt.itemsize)
                * _build.L2NORM_THREADS)
        for n in (1, 7, 4097, tile - 4, tile + 4, 9_000_007):
            hold(f"{dt} n={n}", [mk(n, dt)])
    bf, f32 = torch.bfloat16, torch.float32
    mixed = [mk(7, f32), mk(4097, bf), mk(4100, f32), mk(1, bf),
             mk(9_000_007, f32)]
    hold("five mixed buffers", mixed)
    check(torch.equal(l2norm_flat(mixed), l2norm_flat(mixed)),
          "l2norm_flat: five mixed buffers differ between launches")
    many = [mk(1 + 977 * i, (f32, bf)[i % 2]) for i in range(37)]
    hold("37 buffers (two launches)", many)
    return worst


def phase_bert_kernels(bcfg):
    """The LayerNorm forward and backward, ``l2norm_flat``, ``adam_flat``
    in delta mode and the non-causal flash forward and backward against
    their plain versions on the card, at the BERT step's shapes, with
    timings. Returns ``{name: row}`` for the new kernels, and the extra
    entries for the rows of earlier slices."""
    from apex_tpu_torch.kernels import (
        adam_flat,
        adam_flat_plain,
        flash_attention_bsh_bwd,
        flash_attention_bsh_bwd_plain,
        flash_attention_bsh_fwd,
        flash_attention_bsh_plain,
        l2norm_flat,
        l2norm_flat_plain,
        layer_norm_bwd,
        layer_norm_bwd_plain,
        layer_norm_fwd,
        layer_norm_fwd_plain,
        launch_counts,
        reset_launch_counts,
    )
    from apex_tpu_torch.kernels.flat_ops import adam_scalars
    from apex_tpu_torch.multi_tensor import pad_to

    dev = torch.device("cuda")
    bf16 = torch.bfloat16
    eps = bcfg.layernorm_epsilon
    rows, extra = {}, {}

    # -- LayerNorm: the step's [16384, 1024] bf16 with fp32 w/b and in
    #    fp32 (the fp16 amp path), route 1 at every other chunk count, a
    #    ragged [37, 513] fp32 (route 0), both statistics; dw/db bit-equal
    #    across launches; where route 1 runs, dx bit-equal to route 0's
    #    and both routes timed
    from apex_tpu_torch.kernels.layer_norm import bwd_route

    worst = {"fwd": 0.0, "bwd": 0.0, "route 0 bwd": 0.0}
    main_rows = BERT_BATCH * bcfg.seq_len
    cases = ((main_rows, bcfg.hidden_size, bf16),
             (main_rows, bcfg.hidden_size, torch.float32),
             *LN_NC_SHAPES, (37, 513, torch.float32))
    by_shape = {}
    for n_rows, hidden, dtype in cases:
        tol = BF16_TOL if dtype == bf16 else FP32_TOL
        # the step's and the ragged shape keep their seeds; the chunk
        # counts' 4096-row shapes take one each
        x, w, b, dy = _ln_rows(
            dev, n_rows, hidden, dtype, torch.float32,
            seed=n_rows + (0 if hidden in (bcfg.hidden_size, 513)
                           else hidden))
        want_route = 0 if hidden == 513 else 1
        tag = f"[{n_rows}, {hidden}] {str(dtype)[6:]}"
        for sub in (True, False):
            y, mean, rstd = layer_norm_fwd(x, w, b, eps=eps,
                                           subtract_mean=sub)
            ry, rmean, rrstd = layer_norm_fwd_plain(x, w, b, eps, sub)
            with ln_bwd_routes() as seen:
                got = layer_norm_bwd(x, w, mean, rstd, dy,
                                     subtract_mean=sub)
                again = layer_norm_bwd(x, w, mean, rstd, dy,
                                       subtract_mean=sub)
            want = layer_norm_bwd_plain(x, w, mean, rstd, dy, sub)
            torch.cuda.synchronize()
            what = f"layer_norm {tag} sub={sub}"
            check(seen == [want_route] * 2
                  and bwd_route(hidden, dtype) == want_route,
                  f"{what}: the backward took routes {seen}, expected "
                  f"{want_route}")
            check(close(y, ry, tol) and close(mean, rmean, FP32_TOL)
                  and close(rstd, rrstd, FP32_TOL),
                  f"{what}: fwd err {max_err(y, ry)}, mean "
                  f"{max_err(mean, rmean)}, rstd {max_err(rstd, rrstd)}")
            for name, a, r in zip(("dx", "dw", "db"), got, want):
                check(close(a, r, tol if name == "dx" else FP32_TOL),
                      f"{what}: {name} err {max_err(a, r)}")
            check(all(torch.equal(a, r) for a, r in zip(got, again)),
                  f"{what}: the backward differs between two launches")
            worst["fwd"] = max(worst["fwd"], max_err(y, ry))
            worst["bwd"] = max(worst["bwd"], *(max_err(a, r) for a, r in
                                               zip(got, want)))
            if want_route == 0:
                continue
            launch0, old = ln_bwd_on_route(x, w, mean, rstd, dy, sub, 0)
            torch.cuda.synchronize()
            check(torch.equal(_bits(got[0]), _bits(old[0])),
                  f"{what}: dx not bit-equal to route 0's")
            for name, a, r in zip(("dw", "db"), old[1:], want[1:]):
                check(close(a, r, FP32_TOL),
                      f"{what}: route 0 {name} err {max_err(a, r)}")
            worst["route 0 bwd"] = max(worst["route 0 bwd"],
                                       *(max_err(a, r) for a, r in
                                         zip(old[1:], want[1:])))
            if sub:
                fn = lambda: layer_norm_bwd(x, w, mean, rstd, dy)
                by_shape[tag] = dict(route1_ms=time_ms(fn),
                                     route0_ms=time_ms(launch0))
                by_shape[tag]["route1 / route0"] = (
                    by_shape[tag]["route1_ms"] / by_shape[tag]["route0_ms"])
        del x, w, b, dy, y, mean, rstd, got, again, want
    log(f"layer_norm: kernel vs plain max err {worst} (bf16 atol=rtol=2e-2,"
        f" fp32 and dw/db 1e-3); dx, dw, db bit-equal across two launches; "
        f"route 1 at {sorted(by_shape)}, its dx bit-equal to route 0's; "
        f"ms by shape (fp32 w/b): {json.dumps(by_shape)}")

    n_rows, hidden = BERT_BATCH * bcfg.seq_len, bcfg.hidden_size
    x, w, b, dy = _ln_rows(dev, n_rows, hidden, bf16, torch.float32, seed=5)
    _, mean, rstd = layer_norm_fwd(x, w, b, eps=eps)
    act = n_rows * hidden * 2
    stats = 2 * n_rows * 4
    lf, lfby = bound(2 * act + stats + 2 * hidden * 4,
                     8 * n_rows * hidden, FP32_FLOPS_PER_S)
    lb, lbby = bound(3 * act + stats + 3 * hidden * 4,
                     12 * n_rows * hidden, FP32_FLOPS_PER_S)
    # the library call takes the affine in x's dtype
    xr = x.detach().clone().requires_grad_(True)
    wr, br = (t.to(bf16).requires_grad_(True) for t in (w, b))
    lib_f = lambda: F.layer_norm(xr, (hidden,), wr, br, eps)
    lib_fb = lambda: torch.autograd.grad(lib_f(), (xr, wr, br), dy)
    shape = f"[{n_rows}, {hidden}] bf16, fp32 w/b"
    ln_f = lambda: layer_norm_fwd(x, w, b, eps=eps)
    ln_b = lambda: layer_norm_bwd(x, w, mean, rstd, dy)
    ln_b0, _ = ln_bwd_on_route(x, w, mean, rstd, dy, True, 0)
    rows["layer_norm_fwd"] = dict(
        name="layer_norm_fwd", route="cuda",
        source="apex_tpu_torch/csrc/layer_norm.cu",
        replaces="apex_tpu/kernels/layer_norm.py:126",
        max_abs_err=worst["fwd"], ms=time_ms(ln_f), eager_ms=eager_ms(ln_f),
        plain_ms=time_ms(lambda: layer_norm_fwd_plain(x, w, b, eps, True)),
        bound_ms=lf, bound_by=lfby, library_ms=time_ms(lib_f), shape=shape)
    rows["layer_norm_bwd"] = dict(
        name="layer_norm_bwd", route="cuda",
        source="apex_tpu_torch/csrc/layer_norm.cu",
        replaces="apex_tpu/kernels/layer_norm.py:161",
        max_abs_err=worst["bwd"], ms=time_ms(ln_b), eager_ms=eager_ms(ln_b),
        plain_ms=time_ms(lambda: layer_norm_bwd_plain(x, w, mean, rstd, dy,
                                                      True)),
        bound_ms=lb, bound_by=lbby,
        library_ms=eager_ms(lib_fb) - eager_ms(lib_f), shape=shape,
        bwd_route=bwd_route(hidden, x.dtype), route0_ms=time_ms(ln_b0),
        by_shape=by_shape)
    del x, w, b, dy, mean, rstd, xr, wr, br, ln_b0
    # the fp16 amp path's backward: the same shape widened to fp32
    x, w, b, dy = _ln_rows(dev, n_rows, hidden, torch.float32,
                           torch.float32, seed=6)
    _, mean, rstd = layer_norm_fwd(x, w, b, eps=eps)
    ln_b0, _ = ln_bwd_on_route(x, w, mean, rstd, dy, True, 0)
    lb32, lb32by = bound(3 * 2 * act + stats + 3 * hidden * 4,
                         12 * n_rows * hidden, FP32_FLOPS_PER_S)
    rows["layer_norm_bwd"]["fp32"] = dict(
        ms=time_ms(lambda: layer_norm_bwd(x, w, mean, rstd, dy)),
        route0_ms=time_ms(ln_b0), bound_ms=lb32, bound_by=lb32by,
        bwd_route=bwd_route(hidden, x.dtype),
        shape=f"[{n_rows}, {hidden}] fp32, fp32 w/b")
    r = rows["layer_norm_bwd"]
    log(f"layer_norm_bwd at {shape}: route {r['bwd_route']} {r['ms']:.4f} "
        f"ms, route 0 {r['route0_ms']:.4f} ms (bound {lb:.4f}); fp32 "
        f"{json.dumps(r['fp32'])}")
    del x, w, b, dy, mean, rstd, ln_b0

    # -- l2norm_flat and adam_flat's delta mode on the 335.2M fp32 group
    n = pad_to(bcfg.param_count())
    g = torch.Generator(device=dev).manual_seed(29)
    p = torch.randn(n, generator=g, device=dev) * 0.02
    gr = torch.randn(n, generator=g, device=dev) * 1e-3
    m = torch.randn(n, generator=g, device=dev) * 1e-3
    v = torch.rand(n, generator=g, device=dev) * 1e-6
    norm = l2norm_flat([gr])
    norm2 = l2norm_flat([gr])
    ref = l2norm_flat_plain([gr])
    torch.cuda.synchronize()
    check(torch.equal(norm, norm2), "l2norm_flat differs between launches")
    # fp32 sums of 335M squares in two orders: 1e-4 relative
    check(close(norm, ref, dict(atol=0.0, rtol=1e-4)),
          f"l2norm_flat: {float(norm)} vs plain {float(ref)}")
    l2_err = max_err(norm, ref)
    mixed = [gr[: n // 2], p[: n // 2].to(bf16)]
    check(close(l2norm_flat(mixed), l2norm_flat_plain(mixed),
                dict(atol=0.0, rtol=1e-4)), "l2norm_flat fp32+bf16 groups")
    tail_err = l2_tails(dev)
    ops = device_ops(lambda: l2norm_flat([gr]))
    kernels = [n for k, (n, _) in ops.items() if "l2norm_kernel" in k]
    memsets = [(n, us) for k, (n, us) in ops.items()
               if "memset" in k.lower()]
    check(kernels == [1.0] and [n for n, _ in memsets] == [1.0]
          and len(ops) == 2,
          f"l2norm_flat: a call ran {ops}, expected one l2norm_kernel and "
          f"one memset")
    l2b, l2by = bound(4 * n + 4, 2 * n, FP32_FLOPS_PER_S)
    gb = gr.to(bf16)
    l2bb, l2bby = bound(2 * n + 4, 2 * n, FP32_FLOPS_PER_S)
    bf16_row = dict(
        ms=time_ms(lambda: l2norm_flat([gb]), **TRAIN_TIMING),
        plain_ms=time_ms(lambda: l2norm_flat_plain([gb]), **TRAIN_TIMING),
        bound_ms=l2bb, bound_by=l2bby,
        library_ms=time_ms(lambda: torch.linalg.vector_norm(
            gb, dtype=torch.float32), **TRAIN_TIMING),
        library="torch.linalg.vector_norm(x, dtype=torch.float32)",
        shape=f"one bf16 buffer of n={n}")
    del gb
    rows["l2norm_flat"] = dict(
        name="l2norm_flat", route="cuda",
        source="apex_tpu_torch/csrc/flat_ops.cu",
        replaces="apex_tpu/kernels/flat_ops.py:187",
        max_abs_err=l2_err, ms=time_ms(lambda: l2norm_flat([gr]),
                                       **TRAIN_TIMING),
        eager_ms=eager_ms(lambda: l2norm_flat([gr]), **TRAIN_TIMING),
        plain_ms=time_ms(lambda: l2norm_flat_plain([gr]), **TRAIN_TIMING),
        bound_ms=l2b, bound_by=l2by,
        library_ms=time_ms(lambda: torch.linalg.vector_norm(gr),
                           **TRAIN_TIMING),
        library="torch.linalg.vector_norm",
        shape=f"one fp32 buffer of n={n} (BERT-large, padded)",
        device_ops_per_call=sorted(ops), memset_us=memsets[0][1],
        tail_max_rel_err=tail_err, bf16=bf16_row)
    log(f"l2norm_flat n={n}: {float(norm):.6f} vs plain {float(ref):.6f} "
        f"(rtol 1e-4), bit-equal across launches; fp32+bf16 groups and "
        f"tails ok (worst rel err {tail_err:.3e}); a call ran {ops}; "
        f"{rows['l2norm_flat']['ms']:.4f} ms vs vector_norm "
        f"{rows['l2norm_flat']['library_ms']:.4f} (bound {l2b:.4f}); "
        f"bf16 {json.dumps(bf16_row)}")

    hp = dict(lr=1.0, b1=0.9, b2=0.999, eps=1e-6, weight_decay=0.01,
              bias_correction1=1 - 0.9 ** 3, bias_correction2=1 - 0.999 ** 3,
              grad_scale=0.5)
    scalars = adam_scalars(*hp.values(), dev)
    p_before = p.clone()
    mk, vk, mp, vp = m.clone(), v.clone(), m.clone(), v.clone()
    (dk,), _, _ = adam_flat([p], [gr], [mk], [vk], **hp, out_is_delta=True)
    (dp,), _, _ = adam_flat_plain([p], [gr], [mp], [vp], scalars,
                                  out_is_delta=True)
    torch.cuda.synchronize()
    check(torch.equal(p, p_before), "adam_flat delta mode changed p")
    d_errs = [max_err(a, b_) for a, b_ in ((dk, dp), (mk, mp), (vk, vp))]
    check(close(dk, dp, ADAM_TOL) and close(mk, mp, ADAM_TOL)
          and close(vk, vp, ADAM_TOL), f"adam_flat delta: errs {d_errs}")
    del mp, vp, dp, p_before
    delta_k = lambda: adam_flat([p], [gr], [mk], [vk], **hp,
                                out_is_delta=True)
    db_, dby = bound(28 * n, 17 * n, FP32_FLOPS_PER_S)
    extra["adam_flat"] = dict(
        ms=time_ms(delta_k, **TRAIN_TIMING),
        eager_ms=eager_ms(delta_k, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: adam_flat_plain(
            [p], [gr], [m], [v], scalars, out_is_delta=True),
            **TRAIN_TIMING),
        bound_ms=db_, bound_by=dby, library_ms=None, max_abs_err=max(d_errs),
        shape=f"delta mode (LAMB stage 1), one fp32 group of n={n}")
    log(f"adam_flat delta mode n={n}: p untouched, max|delta,m,v - plain|="
        f"{d_errs} (tol atol=1e-6 rtol=1e-5)")
    del p, gr, m, v, mk, vk, dk

    # -- flash, bidirectional: bwd in fp32 at b=2 s=512 (8 key tiles),
    #    then forward and backward at the step's b=32 s=512 in bf16
    heads, hd = bcfg.num_heads, bcfg.hidden_size // bcfg.num_heads
    s = bcfg.seq_len

    def inputs(b_, dtype, seed):
        gg = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(b_, s, bcfg.hidden_size, generator=gg,
                            device=dev, dtype=dtype) for _ in range(4)]

    def delta_of(out, do):
        b_ = out.shape[0]
        return (out.float() * do.float()).view(b_, s, heads, hd).sum(
            -1).transpose(1, 2).contiguous()

    q, k, v_, do = inputs(2, torch.float32, 31)
    reset_launch_counts()
    out, lse = flash_attention_bsh_fwd(q, k, v_, num_heads=heads,
                                       causal=False)
    check_tc("BERT flash fp32", launch_counts(), "flash_attention_bsh",
             want=0)
    ref, ref_lse = flash_attention_bsh_plain(q, k, v_, num_heads=heads,
                                             causal=False)
    dl = delta_of(out, do)
    got = flash_attention_bsh_bwd(q, k, v_, do, lse, dl, num_heads=heads,
                                  causal=False)
    want = flash_attention_bsh_bwd_plain(q, k, v_, do, lse, dl,
                                         num_heads=heads, causal=False)
    torch.cuda.synchronize()
    check(close(out, ref, FP32_TOL) and close(lse, ref_lse, FP32_TOL),
          f"flash non-causal fp32 b=2: out {max_err(out, ref)}")
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        check(close(a, r, FP32_TOL), f"flash bwd non-causal fp32 b=2 s={s}:"
              f" {name} err {max_err(a, r)}")
    f32_err = max(max_err(a, r) for a, r in zip(got, want))

    B = BERT_BATCH
    q, k, v_, do = inputs(B, bf16, 37)
    reset_launch_counts()
    out, lse = flash_attention_bsh_fwd(q, k, v_, num_heads=heads,
                                       causal=False)
    check_tc(f"BERT flash b={B}", launch_counts(), "flash_attention_bsh",
             want=1)
    ref, ref_lse = flash_attention_bsh_plain(q, k, v_, num_heads=heads,
                                             causal=False)
    torch.cuda.synchronize()
    check(close(out, ref, TC_TOL) and close(lse, ref_lse, FP32_TOL),
          f"flash non-causal b={B}: out err {max_err(out, ref)}, lse err "
          f"{max_err(lse, ref_lse)}")
    fwd_err = max_err(out, ref)
    fwd_lse_err = max_err(lse, ref_lse)
    del ref, ref_lse
    dl = delta_of(out, do)
    reset_launch_counts()
    got = flash_attention_bsh_bwd(q, k, v_, do, lse, dl, num_heads=heads,
                                  causal=False)
    check_tc(f"BERT flash bwd b={B}", launch_counts(),
             "flash_attention_bsh_bwd", want=1)
    want = flash_attention_bsh_bwd_plain(q, k, v_, do, lse, dl,
                                         num_heads=heads, causal=False)
    torch.cuda.synchronize()
    bwd_errs = [max_err(a, r) for a, r in zip(got, want)]
    seen = {}
    hold_bwd_tc(f"flash bwd non-causal b={B}", got, want, seen)
    cc_launch, cc = bsh_bwd_cuda_core(q, k, v_, do, lse, dl, heads, False)
    torch.cuda.synchronize()
    hold_bwd_tc(f"flash bwd non-causal b={B}", cc, want, seen,
                side="cuda_core")
    check_cc_fails(f"flash bwd non-causal b={B}", cc, want)
    del got, want, cc
    log(f"flash non-causal: fp32 b=2 s={s} bwd max err {f32_err:.3e} (tol "
        f"1e-3); b={B} s={s} bf16 fwd {fwd_err:.3e}, bwd {bwd_errs}; "
        f"(atol_rel, rms) against the rounding twin: tensor cores "
        f"{seen['tc']}, CUDA cores {seen['cuda_core']} (BWD_TC_TOL "
        f"{BWD_TC_TOL})")
    hv = lambda t: t.view(B, s, heads, hd).transpose(1, 2)
    qh, kh, vh = (hv(t).detach().requires_grad_(True) for t in (q, k, v_))
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh)
        torch.autograd.grad(o, (qh, kh, vh), hv(do))

    pairs = B * heads * s * s
    act = B * s * bcfg.hidden_size * 2
    st = B * heads * s * 4
    fb, fby = bound(4 * act + st, 4 * hd * pairs)
    bb, bby = bound(7 * act + 2 * st, 5 * 2 * hd * pairs)
    fa = lambda: flash_attention_bsh_fwd(q, k, v_, num_heads=heads,
                                         causal=False)
    fbw = lambda: flash_attention_bsh_bwd(q, k, v_, do, lse, dl,
                                          num_heads=heads, causal=False)
    shape = f"b={B} s={s} hidden={bcfg.hidden_size} heads={heads} bf16 " \
            f"non-causal"
    extra["flash_attention_bsh"] = dict(
        ms=time_ms(fa, **TRAIN_TIMING), eager_ms=eager_ms(fa, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_plain(
            q, k, v_, num_heads=heads, causal=False), **TRAIN_TIMING),
        library_ms=time_ms(lib_fwd, **TRAIN_TIMING), bound_ms=fb,
        bound_by=fby, max_abs_err=fwd_err, max_lse_err=fwd_lse_err,
        shape=shape)
    lib_fwd_ms = extra["flash_attention_bsh"]["library_ms"]
    extra["flash_attention_bsh_bwd"] = dict(
        ms=time_ms(fbw, **TRAIN_TIMING),
        eager_ms=eager_ms(fbw, **TRAIN_TIMING),
        prev_ms=time_ms(cc_launch, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_bwd_plain(
            q, k, v_, do, lse, dl, num_heads=heads, causal=False),
            **TRAIN_TIMING),
        library_ms=time_ms(lib_fwd_bwd, **TRAIN_TIMING) - lib_fwd_ms,
        bound_ms=bb, bound_by=bby, max_abs_err=max(bwd_errs + [f32_err]),
        tol=dict(BWD_TC_TOL, tc=seen["tc"], cuda_core=seen["cuda_core"]),
        shape=shape)
    del q, k, v_, do, qh, kh, vh, out, lse, dl, cc_launch
    for name, r in list(rows.items()) + [(f"{k_} (BERT)", r_)
                                         for k_, r_ in extra.items()]:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        prev = (f", the CUDA-core kernel {r['prev_ms']:.4f} ms"
                if "prev_ms" in r else "")
        log(f"kernel {name}: {r['ms']:.4f} ms (eager {r['eager_ms']:.4f} "
            f"ms){prev}, plain {r['plain_ms']:.4f} ms, library {lib} ms, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']}) at {r['shape']}")
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows, extra


# ---------------------------------------------------------------------------
# phase 12: gradients at BERT-large width
# ---------------------------------------------------------------------------

def phase_bert_grads(bcfg, params, tok, tgt, mask):
    """One ``mlm_loss`` gradient on the batch's first 4 rows through the
    kernels (bf16, ``ln_impl="pallas"``, flash), through the "xla"
    attention and LayerNorm in bf16, and in fp32 (the reference), on the
    same weights, held by :func:`_hold_grads` as phase 8 holds GPT's."""
    import dataclasses

    from apex_tpu_torch.models import bert

    xla = dict(attn_impl="xla", ln_impl="xla")
    paths = {"kernel": dataclasses.replace(bcfg, attn_impl="flash",
                                           ln_impl="pallas"),
             "xla": dataclasses.replace(bcfg, **xla),
             "fp32": dataclasses.replace(bcfg, **xla,
                                         compute_dtype=torch.float32)}
    torch.backends.cuda.matmul.allow_tf32 = False
    tok, tgt, mask = tok[:4], tgt[:4], mask[:4]
    got = {name: _loss_grads(
        lambda p, c=c: bert.mlm_loss(c, p, tok, tgt, mask), params)
        for name, c in paths.items()}
    return _hold_grads("BERT grads, batch 4", got)


# ---------------------------------------------------------------------------
# phase 13: the BERT step; phase 14: where its time goes
# ---------------------------------------------------------------------------

def bert_launches_per_step(cfg):
    """Kernel launches one MLM step makes, from the code: every block runs
    twice forward (the forward, then remat's replay in the backward), so
    flash forward 2L and backward L; LayerNorm forward 3 (embedding,
    final, MLM head) plus, with ``ln_impl="pallas"``, ln1 and ln2 of 2L
    block runs, and backward 3 plus 2L; the flat LAMB one ``l2norm_flat``
    and one ``adam_flat`` (one fp32 group), the tree LAMB none. In bf16
    and fp16 every flash forward and backward is the tensor-core
    kernel's."""
    L = cfg.num_layers
    pallas = cfg.ln_impl == "pallas"
    # bf16 and fp16 run the tensor-core kernels (heads of 64); fp32 the
    # CUDA-core ones
    tc = cfg.compute_dtype in (torch.bfloat16, torch.float16)
    return {"flash_attention_bsh": 2 * L,
            "flash_attention_bsh_tc": 2 * L * tc,
            "flash_attention_bsh_bwd": L, "flash_attention_bsh_bwd_tc": L * tc,
            "layer_norm_fwd": 3 + (4 * L if pallas else 0),
            "layer_norm_bwd": 3 + (2 * L if pallas else 0)}


def phase_bert_train(bcfg, layout, tok, tgt, mask):
    """``make_mlm_train_step`` with ``fused_lamb(1e-3, layout=layout)`` and
    the identity scaler: one warm-up step and ``TRAIN_STEPS`` timed ones,
    weights from seed 0, launch counts zeroed just before and read just
    after. Returns (metrics, state, step_fn)."""
    from apex_tpu_torch.amp import ScalerConfig
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import make_mlm_train_step
    from apex_tpu_torch.optimizers import fused_lamb

    init_fn, step_fn = make_mlm_train_step(
        bcfg, fused_lamb(1e-3, layout=layout), ScalerConfig(enabled=False))
    state = init_fn(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with ln_bwd_routes() as routes:
        t0 = time.perf_counter()
        state, m = step_fn(state, tok, tgt, mask)
        losses = [m["loss"]]
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, m = step_fn(state, tok, tgt, mask)
            losses.append(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = [float(x) for x in losses]
    n_steps = TRAIN_STEPS + 1
    run = f"BERT {layout} ln_impl={bcfg.ln_impl}"
    metrics = dict(
        run=run, train_tokens_per_sec=TRAIN_STEPS * tok.numel() / wall,
        step_ms=wall / TRAIN_STEPS * 1e3, warmup_step_ms=warm * 1e3,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        losses=losses, launches=counts,
        launches_per_step={k: v / n_steps for k, v in counts.items()},
        ln_bwd_route1=routes.count(1))
    log(f"train {run}: " + json.dumps(metrics))
    check(all(np.isfinite(losses)), f"train {run}: non-finite loss")
    check(abs(losses[0] - math.log(bcfg.vocab_size)) < 1.0,
          f"train {run}: first loss {losses[0]} is not near ln(vocab) "
          f"{math.log(bcfg.vocab_size):.3f}")
    check(losses[-1] < losses[0] - BERT_LOSS_FALL,
          f"train {run}: the loss did not fall by {BERT_LOSS_FALL} on the "
          f"repeated batch")
    want = bert_launches_per_step(bcfg)
    flat = layout == "flat"
    want.update(l2norm_flat=int(flat), adam_flat=int(flat),
                decode_attention=0, decode_write_column=0)
    for name, per_step in want.items():
        check(counts[name] == per_step * n_steps,
              f"train {run}: {name} launched {counts[name]} times, expected "
              f"{per_step} x {n_steps} steps")
    # hidden 1024 in bf16 and fp32 is route 1's
    check(routes == [1] * counts["layer_norm_bwd"],
          f"train {run}: LayerNorm backward routes {sorted(set(routes))} "
          f"over {len(routes)} calls, expected route 1 for all "
          f"{counts['layer_norm_bwd']} launches")
    return metrics, state, step_fn


# ---------------------------------------------------------------------------
# phase 21: the fused cross entropy's kernels and fp16 flash, at their shapes
# ---------------------------------------------------------------------------

#: xentropy kernel vs plain: loss and lse in fp32 differ only by the
#: order of the sums (the kernel's running max and rescaled sum); dx =
#: softmax - onehot is about 1/V = 2e-5 a column, so a fixed atol of
#: 1e-3 would pass a kernel that dropped the softmax term: 1e-6 absolute
#: and 1e-4 relative (an lse 1e-5 apart moves every softmax by 1e-5
#: relative)
XENT_DX_TOL = dict(atol=1e-6, rtol=1e-4)


def _xent_inputs(dev, rows, vocab, dtype, seed, ignore_every=0):
    """Logits ``[rows, vocab]`` of scale 3, targets in range, every
    ``ignore_every``-th row ignored, and the last row's target past the
    vocab (``x[t]`` reads 0)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(rows, vocab, generator=g, device=dev) * 3).to(dtype)
    t = torch.randint(0, vocab, (rows,), generator=g, device=dev)
    if ignore_every:
        t[::ignore_every] = -100
    t[-1] = vocab + 5
    dy = torch.randn(rows, generator=g, device=dev)
    return x, t, dy


def _f16_range_check(q, k, v, do, lse, delta, heads: int) -> dict:
    """fp16's range in the tensor-core backward, which rounds dS to fp16
    where JAX (and the fp32 route) keep it in fp32: ``do`` times 2^e for
    the largest e at which the fp32 route's gradients (the widened inputs,
    rounded to fp16 at the end) are all finite, as amp's loss scale puts
    ``do`` near that edge. There the kernel's gradients must be finite
    and within F16_BWD_TC_TOL of the rounding twin's. Returns e, why the
    next e failed, and the largest |dS| (fp32, what the kernel rounds)
    against fp16's largest finite 65504."""
    from apex_tpu_torch.kernels import (
        flash_attention_bsh_bwd,
        flash_attention_bsh_bwd_plain,
    )
    from apex_tpu_torch.kernels.flash_attention import _p_ds_plain

    wide = [t_.float() for t_ in (q, k, v)]
    top, why = None, "none: e = 30 reached"
    for e in range(31):
        do_e = (do.float() * 2.0 ** e).half()
        if not bool(torch.isfinite(do_e).all()):
            why = f"e = {e}: do itself overflows fp16"
            break
        g32 = flash_attention_bsh_bwd(*wide, do_e.float(), lse,
                                      delta * 2.0 ** e, num_heads=heads)
        if not all(bool(torch.isfinite(t_.half()).all()) for t_ in g32):
            why = f"e = {e}: the fp32 route's gradients overflow fp16"
            break
        top = e
    check(top is not None, "fp16 range: no scale of do kept the fp32 route "
          "finite")
    do_e = (do.float() * 2.0 ** top).half()
    delta_e = delta * 2.0 ** top
    got = flash_attention_bsh_bwd(q, k, v, do_e, lse, delta_e,
                                  num_heads=heads)
    want = flash_attention_bsh_bwd_plain(q, k, v, do_e, lse, delta_e,
                                         num_heads=heads)
    b, s, hidden = q.shape
    bh, d = b * heads, hidden // heads
    hm = lambda t_: t_.float().view(b, s, heads, d).transpose(1, 2).reshape(
        bh, s, d)
    _, ds = _p_ds_plain(hm(q), hm(k), hm(v), hm(do_e), lse.reshape(bh, s),
                        delta_e.reshape(bh, s), causal=False, scale=d ** -0.5,
                        lens=None, segs=None, n_rep=1)
    ds_max = float(ds.abs().max())
    del ds
    seen = {}
    hold_bwd_tc(f"fp16 range, do x 2^{top}", got, want, seen,
                tol=F16_BWD_TC_TOL)
    out = dict(e=top, stopped=why, max_abs_ds=ds_max,
               max_abs_grad=max(float(t_.float().abs().max()) for t_ in got),
               tc=seen["tc"])
    log(f"fp16 range: do x 2^{top} (next: {why}); largest |dS| {ds_max:.4g} "
        f"(fp16 max 65504), largest |grad| {out['max_abs_grad']:.4g}; the "
        f"kernel's gradients finite, (atol_rel, rms) {seen['tc']}")
    return out


def _f16_bsh_flash(bcfg) -> dict:
    """Phase 21's fp16 flash at the BERT step's shape (b=32, s=512, 16
    heads of 64, non-causal): the forward and backward on the tensor-core
    kernels' fp16 instantiation against the twins that round P and dS to
    fp16 (F16_TC_TOL, F16_BWD_TC_TOL), the fp32 route on the widened
    inputs measured beside them (it must miss the backward's RMS bound),
    fp16's range (:func:`_f16_range_check`), and the times of the kernels,
    the fp32 route, plain, fp16 SDPA and the bound. Returns the two flash
    rows' fp16 entries."""
    from apex_tpu_torch.kernels import (
        flash_attention_bsh_bwd,
        flash_attention_bsh_bwd_plain,
        flash_attention_bsh_fwd,
        flash_attention_bsh_plain,
        launch_counts,
        reset_launch_counts,
    )

    dev = torch.device("cuda")
    extra = {}
    heads, s, hidden = bcfg.num_heads, bcfg.seq_len, bcfg.hidden_size
    hd, B, f16 = hidden // heads, BERT_BATCH, torch.float16
    g = torch.Generator(device=dev).manual_seed(41)
    q, k, v, do = (torch.randn(B, s, hidden, generator=g, device=dev,
                               dtype=f16) for _ in range(4))
    q32, k32, v32, do32 = (t_.float() for t_ in (q, k, v, do))
    reset_launch_counts()
    out, lse = flash_attention_bsh_fwd(q, k, v, num_heads=heads)
    check_tc("flash fp16", launch_counts(), "flash_attention_bsh", want=1)
    ref, ref_lse = flash_attention_bsh_plain(q, k, v, num_heads=heads)
    cc_out, _ = flash_attention_bsh_fwd(q32, k32, v32, num_heads=heads)
    torch.cuda.synchronize()
    fwd_atol = atol_needed(out, ref, F16_TC_TOL["rtol"])
    cc_atol = atol_needed(cc_out.half(), ref, F16_TC_TOL["rtol"])
    check(out.dtype == f16 and bool(torch.isfinite(out).all())
          and close(out, ref, F16_TC_TOL) and close(lse, ref_lse, FP32_TOL),
          f"flash fp16 b={B}: out needs atol {fwd_atol:.3e} (F16_TC_TOL "
          f"{F16_TC_TOL}), lse err {max_err(lse, ref_lse)}")
    fwd_err = max_err(out, ref)
    del ref, ref_lse, cc_out
    delta = (out.float() * do.float()).view(B, s, heads, hd).sum(
        -1).transpose(1, 2).contiguous()
    reset_launch_counts()
    got = flash_attention_bsh_bwd(q, k, v, do, lse, delta, num_heads=heads)
    check_tc("flash bwd fp16", launch_counts(), "flash_attention_bsh_bwd",
             want=1)
    want = flash_attention_bsh_bwd_plain(q, k, v, do, lse, delta,
                                         num_heads=heads)
    cc = flash_attention_bsh_bwd(q32, k32, v32, do32, lse, delta,
                                 num_heads=heads)
    torch.cuda.synchronize()
    seen = {}
    hold_bwd_tc(f"flash bwd fp16 b={B}", got, want, seen, tol=F16_BWD_TC_TOL)
    check(all(a.dtype == f16 for a in got), "flash bwd fp16: dtypes")
    hold_bwd_tc(f"flash bwd fp16 b={B}", [t_.half() for t_ in cc], want,
                seen, side="cuda_core", tol=F16_BWD_TC_TOL)
    check_cc_fails(f"flash bwd fp16 b={B}", [t_.half() for t_ in cc], want,
                   F16_BWD_TC_TOL)
    bwd_err = max(max_err(a, r) for a, r in zip(got, want))
    del got, want, cc
    log(f"flash fp16 b={B} s={s} (tensor cores vs the fp16-rounding twins):"
        f" fwd needs atol {fwd_atol:.3e} at rtol 2^-10 (the fp32 CUDA-core "
        f"kernel on widened inputs {cc_atol:.3e}; F16_TC_TOL {F16_TC_TOL}); "
        f"bwd (atol_rel, rms) tensor cores {seen['tc']}, CUDA cores "
        f"{seen['cuda_core']} (F16_BWD_TC_TOL {F16_BWD_TC_TOL})")
    range_check = _f16_range_check(q, k, v, do, lse, delta, heads)
    hv = lambda t_: t_.view(B, s, heads, hd).transpose(1, 2)
    qh, kh, vh = (hv(t_).detach().requires_grad_(True) for t_ in (q, k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh)

    def lib_fwd_bwd():
        o = F.scaled_dot_product_attention(qh, kh, vh)
        torch.autograd.grad(o, (qh, kh, vh), hv(do))

    pairs = B * heads * s * s
    act = B * s * hidden * 2
    st = B * heads * s * 4
    fb, fby = bound(4 * act + st, 4 * hd * pairs)
    bb, bby = bound(7 * act + 2 * st, 5 * 2 * hd * pairs)
    fa = lambda: flash_attention_bsh_fwd(q, k, v, num_heads=heads)
    fbw = lambda: flash_attention_bsh_bwd(q, k, v, do, lse, delta,
                                          num_heads=heads)
    # the route fp16 took before its tensor-core instantiation: widen,
    # the fp32 CUDA-core kernel, cast back (the fp32 route called as is)
    prev_f = lambda: flash_attention_bsh_fwd(
        q.float(), k.float(), v.float(), num_heads=heads)[0].half()
    prev_b = lambda: [t_.half() for t_ in flash_attention_bsh_bwd(
        q.float(), k.float(), v.float(), do.float(), lse, delta,
        num_heads=heads)]
    shape = f"b={B} s={s} hidden={hidden} heads={heads} fp16 non-causal"
    prev_src = ("measured in this run: the fp32 route (widen, "
                "csrc/flash_attention_bsh{}.cu's fp32 kernel, cast back) on "
                "the same inputs")
    extra["flash_attention_bsh"] = dict(
        ms=time_ms(fa, **TRAIN_TIMING), eager_ms=eager_ms(fa, **TRAIN_TIMING),
        prev_ms=time_ms(prev_f, **TRAIN_TIMING),
        prev_ms_source=prev_src.format(""),
        fp32_kernel_ms=time_ms(lambda: flash_attention_bsh_fwd(
            q32, k32, v32, num_heads=heads), **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_plain(
            q, k, v, num_heads=heads), **TRAIN_TIMING),
        library_ms=time_ms(lib_fwd, **TRAIN_TIMING), bound_ms=fb,
        bound_by=fby, max_abs_err=fwd_err, atol_needed=fwd_atol,
        cuda_core_atol_needed=cc_atol, tol=F16_TC_TOL, shape=shape)
    extra["flash_attention_bsh_bwd"] = dict(
        ms=time_ms(fbw, **TRAIN_TIMING),
        eager_ms=eager_ms(fbw, **TRAIN_TIMING),
        prev_ms=time_ms(prev_b, **TRAIN_TIMING),
        prev_ms_source=prev_src.format("_bwd"),
        fp32_kernel_ms=time_ms(lambda: flash_attention_bsh_bwd(
            q32, k32, v32, do32, lse, delta, num_heads=heads),
            **TRAIN_TIMING),
        plain_ms=time_ms(lambda: flash_attention_bsh_bwd_plain(
            q, k, v, do, lse, delta, num_heads=heads), **TRAIN_TIMING),
        library_ms=(time_ms(lib_fwd_bwd, **TRAIN_TIMING)
                    - time_ms(lib_fwd, **TRAIN_TIMING)),
        bound_ms=bb, bound_by=bby, max_abs_err=bwd_err,
        tol=dict(F16_BWD_TC_TOL, tc=seen["tc"],
                 cuda_core=seen["cuda_core"]),
        range_check=range_check, shape=shape)
    del q, k, v, do, q32, k32, v32, do32, qh, kh, vh, out, lse, delta
    return extra


def phase_xent_kernels(tcfg, bcfg):
    """The xentropy forward and backward against their plain versions on
    the card at one CE chunk of the GPT step ([batch * ce_chunk, vocab]
    fp32, smoothing 0 and 0.1, every 7th row ignored) and at ragged
    shapes (V % 4 != 0, unaligned bf16 rows); then the flash kernels with
    float16 inputs at the BERT step's shape (:func:`_f16_bsh_flash`).
    Timed as in phase 3. Returns (``{name: row}`` for the two new
    kernels, the flash rows' fp16 entries)."""
    from apex_tpu_torch.kernels import (
        reset_launch_counts,
        xentropy_bwd,
        xentropy_bwd_plain,
        xentropy_fwd,
        xentropy_fwd_plain,
    )

    dev = torch.device("cuda")
    rows_out = {}
    worst = {"fwd": 0.0, "bwd": 0.0}

    def both(x, t, dy, eps):
        loss, lse = xentropy_fwd(x, t, smoothing=eps)
        rl, rlse = xentropy_fwd_plain(x, t, eps)
        dx = xentropy_bwd(x, t, lse, dy, smoothing=eps)
        rdx = xentropy_bwd_plain(x, t, lse, dy, eps)
        torch.cuda.synchronize()
        return (loss, lse, dx), (rl, rlse, rdx)

    # ragged: V % 4 != 0 (scalar tails), bf16 rows of 600 bytes (every
    # other row starts off a 16-byte boundary: scalar heads)
    for rows, vocab, dtype in ((37, 50257, torch.float32),
                               (29, 300, torch.bfloat16),
                               (5, 3, torch.float32)):
        x, t, dy = _xent_inputs(dev, rows, vocab, dtype, rows, 3)
        for eps in (0.0, 0.1):
            (loss, lse, dx), (rl, rlse, rdx) = both(x, t, dy, eps)
            what = f"xentropy [{rows}, {vocab}] {dtype} eps={eps}"
            check(close(loss, rl, FP32_TOL) and close(lse, rlse, FP32_TOL),
                  f"{what}: loss err {max_err(loss, rl)}, lse err "
                  f"{max_err(lse, rlse)}")
            tol = XENT_DX_TOL if dtype == torch.float32 else BF16_TOL
            check(close(dx, rdx, tol), f"{what}: dx err {max_err(dx, rdx)}")
            ign = t == -100
            check(bool((loss[ign] == 0).all() and (dx[ign] == 0).all()),
                  f"{what}: an ignored row has loss or gradient")
            worst["fwd"] = max(worst["fwd"], max_err(loss, rl))
            worst["bwd"] = max(worst["bwd"], max_err(dx, rdx))

    rows, vocab = TRAIN_BATCH * tcfg.ce_chunk, tcfg.vocab_size
    x, t, dy = _xent_inputs(dev, rows, vocab, torch.float32, 23, 7)
    for eps in (0.0, 0.1):
        (loss, lse, dx), (rl, rlse, rdx) = both(x, t, dy, eps)
        what = f"xentropy [{rows}, {vocab}] fp32 eps={eps}"
        check(bool(torch.isfinite(loss).all() and torch.isfinite(dx).all()),
              f"{what}: non-finite")
        check(close(loss, rl, FP32_TOL) and close(lse, rlse, FP32_TOL),
              f"{what}: loss err {max_err(loss, rl)}, lse err "
              f"{max_err(lse, rlse)}")
        check(close(dx, rdx, XENT_DX_TOL), f"{what}: dx err "
              f"{max_err(dx, rdx)}")
        worst["fwd"] = max(worst["fwd"], max_err(loss, rl), max_err(lse, rlse))
        worst["bwd"] = max(worst["bwd"], max_err(dx, rdx))
        del rl, rlse, rdx
    log(f"xentropy: kernel vs plain max err {worst} (loss/lse atol=rtol=1e-3,"
        f" dx atol 1e-6 rtol 1e-4, bf16 dx 2e-2) at [{rows}, {vocab}] fp32 "
        f"and ragged [37, 50257], [29, 300] bf16, [5, 3]")

    # timed at the chunk's shape, eps = 0 (the GPT step's); the library
    # call refuses a target past the vocab (a device assert), so its
    # copy of the targets holds 0 there
    tl = torch.where(t >= vocab, torch.zeros_like(t), t).long()
    lse = xentropy_fwd(x, t)[1]
    xr = x.detach().clone().requires_grad_(True)
    lib_f = lambda: F.cross_entropy(x, tl, reduction="none")
    lib_fr = lambda: F.cross_entropy(xr, tl, reduction="none")
    lib_fb = lambda: torch.autograd.grad(lib_fr(), xr, dy)
    fwd_k = lambda: xentropy_fwd(x, t)
    bwd_k = lambda: xentropy_bwd(x, t, lse, dy)
    n = rows * vocab
    # forward: read the logits and targets, write loss and lse; about 4
    # fp32 operations an element (compare, subtract, exp, add)
    xb, xby = bound(4 * n + 12 * rows, 4 * n, FP32_FLOPS_PER_S)
    # backward: read the logits, targets, lse and g, write dx
    bb, bby = bound(8 * n + 12 * rows, 5 * n, FP32_FLOPS_PER_S)
    shape = f"[{rows}, {vocab}] fp32 (one CE chunk of the GPT step)"
    rows_out["xentropy_fwd"] = dict(
        name="xentropy_fwd", route="cuda",
        source="apex_tpu_torch/csrc/xentropy.cu",
        replaces="apex_tpu/kernels/xentropy.py:79",
        max_abs_err=worst["fwd"], ms=time_ms(fwd_k, **TRAIN_TIMING),
        eager_ms=eager_ms(fwd_k, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: xentropy_fwd_plain(x, t), **TRAIN_TIMING),
        bound_ms=xb, bound_by=xby,
        library_ms=time_ms(lib_f, **TRAIN_TIMING), shape=shape)
    rows_out["xentropy_bwd"] = dict(
        name="xentropy_bwd", route="cuda",
        source="apex_tpu_torch/csrc/xentropy.cu",
        replaces="apex_tpu/kernels/xentropy.py:107",
        max_abs_err=worst["bwd"], ms=time_ms(bwd_k, **TRAIN_TIMING),
        eager_ms=eager_ms(bwd_k, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: xentropy_bwd_plain(x, t, lse, dy),
                         **TRAIN_TIMING),
        bound_ms=bb, bound_by=bby,
        library_ms=(eager_ms(lib_fb, **TRAIN_TIMING)
                    - eager_ms(lib_fr, **TRAIN_TIMING)), shape=shape)
    del x, t, dy, lse, xr, loss, dx

    extra = _f16_bsh_flash(bcfg)
    for name, r in list(rows_out.items()) + [(f"{k_} (fp16)", r_)
                                             for k_, r_ in extra.items()]:
        fp32 = (f", the fp32 route {r['prev_ms']:.4f} ms (its kernel alone "
                f"{r['fp32_kernel_ms']:.4f} ms)"
                if "fp32_kernel_ms" in r else "")
        log(f"kernel {name}: {r['ms']:.4f} ms (eager {r['eager_ms']:.4f} "
            f"ms){fp32}, plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}) at {r['shape']}")
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows_out, extra


# ---------------------------------------------------------------------------
# phase 22: bench's GPT step with the fused cross entropy
# ---------------------------------------------------------------------------

#: fused vs "xla" cross entropy in the GPT step: the same loss in fp32,
#: its lse summed in another order, so the first step's losses agree to
#: fp32 rounding of a ~10.8 value; later steps carry bf16 training's
#: rounding forward, as the two optimizer layouts do (LAYOUT_LOSS_BAND)
FUSED_CE_STEP0_TOL = 1e-4
FUSED_CE_LOSS_BAND = 5e-2


def phase_fused_ce_train(tcfg, tok, tgt, xla_tree):
    """Phase 9's tree-layout step with ``ce_impl="fused"``: its losses
    against the "xla" run's (``xla_tree``, phase 9's metrics), and per
    step 2 x (seq / ce_chunk) forward and seq / ce_chunk backward
    launches of the xentropy kernels (the chunk checkpoint replays the
    forward). Returns the run's metrics."""
    import dataclasses

    cfg = dataclasses.replace(tcfg, ce_impl="fused")
    fused, state, step_fn = phase_train(cfg, "tree", tok, tgt)
    del state, step_fn
    torch.cuda.empty_cache()
    a, b = fused["losses"], xla_tree["losses"]
    gap = max(abs(x - y) for x, y in zip(a, b))
    log(f"fused CE: step 0 loss {a[0]:.6f} vs xla {b[0]:.6f}; max|loss "
        f"diff| over {len(a)} steps {gap:.3e} (band {FUSED_CE_LOSS_BAND}); "
        f"step {fused['step_ms']:.2f} ms vs {xla_tree['step_ms']:.2f} ms, "
        f"peak {fused['peak_memory_bytes']} vs "
        f"{xla_tree['peak_memory_bytes']} bytes")
    check(abs(a[0] - b[0]) <= FUSED_CE_STEP0_TOL,
          f"fused CE: step 0 loss {a[0]} vs xla {b[0]}")
    check(gap <= FUSED_CE_LOSS_BAND, f"fused CE: losses differ by {gap}")
    return fused


# ---------------------------------------------------------------------------
# phase 23: BERT-large in fp16 under amp's dynamic scaler
# ---------------------------------------------------------------------------

#: the forced overflow: one step at this loss scale, where BERT-large's
#: fp16 gradients overflow; the backoff then halves it and clamps it to
#: the scaler's max_scale (2^24)
FORCED_SCALE = 2.0 ** 40


def phase_bert_fp16(tok, tgt, mask):
    """``examples/bert_pretrain.py --fp16``: ``BertConfig(compute_dtype=
    float16)`` (flash on its fp16 tensor-core kernels), tree LAMB, the
    scaler of ``amp.initialize("O2", half_dtype=float16)`` (the example's
    ``ScalerConfig()``). First one step at a forced loss scale of 2^40:
    skipped, params and LAMB state bit for bit as they were, the scale
    backed off (and clamped to 2^24); then, from 2^16 again, one warm-up
    and ``TRAIN_STEPS`` timed steps: each step's scale and skip, every one
    after the forced step applied, the loss falling over the applied
    steps, and the launches the code implies over all steps (every flash
    launch on the tensor cores); then a profiled window of 2 steps.
    Returns the run's metrics, the profile under ``"profile"``."""
    from apex_tpu_torch import _tree, amp
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import make_mlm_train_step
    from apex_tpu_torch.optimizers import fused_lamb

    ctx, _ = amp.initialize(opt_level="O2", half_dtype=torch.float16)
    check(ctx.scaler == amp.ScalerConfig(),
          f"amp O2 fp16 scaler {ctx.scaler} is not ScalerConfig()")
    bcfg = bert_config(compute_dtype=torch.float16)
    init_fn, step_fn = make_mlm_train_step(
        bcfg, fused_lamb(1e-3, layout="tree"), ctx.scaler)
    state = init_fn(torch.Generator("cuda").manual_seed(0))
    scale0 = state.scaler.loss_scale.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()

    state = state._replace(scaler=state.scaler._replace(
        loss_scale=torch.full((), FORCED_SCALE, device="cuda")))
    before = [t.clone() for t in _tree.leaves((state.params,
                                               state.opt_state))]
    state, m = step_fn(state, tok, tgt, mask)
    forced = (int(m["grads_finite"]), float(m["loss_scale"]))
    same = all(torch.equal(a, b) for a, b in zip(
        _tree.leaves((state.params, state.opt_state)), before))
    del before
    log(f"BERT fp16 forced step at scale 2^40: grads_finite {forced[0]}, "
        f"scale after {forced[1]}, params and LAMB state bit-equal: {same}")
    backed = min(FORCED_SCALE * ctx.scaler.backoff_factor,
                 ctx.scaler.max_scale)
    check(forced == (0, backed),
          f"BERT fp16: the forced step gave {forced}, expected a skip and "
          f"a scale of {backed} (halved, clamped to max_scale)")
    check(same, "BERT fp16: a skipped step changed params or LAMB state")

    state = state._replace(scaler=state.scaler._replace(loss_scale=scale0))
    ms_ = []
    t0 = time.perf_counter()
    state, m = step_fn(state, tok, tgt, mask)
    ms_.append(m)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, tok, tgt, mask)
        ms_.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    steps = [dict(loss=float(m["loss"]), grads_finite=int(m["grads_finite"]),
                  loss_scale=float(m["loss_scale"])) for m in ms_]
    applied = [s_["loss"] for s_ in steps if s_["grads_finite"]]
    n_steps = TRAIN_STEPS + 2
    metrics = dict(
        run="BERT fp16 tree ln_impl=xla",
        train_tokens_per_sec=TRAIN_STEPS * tok.numel() / wall,
        step_ms=wall / TRAIN_STEPS * 1e3, warmup_step_ms=warm * 1e3,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        forced_step=forced, steps=steps, launches=counts,
        launches_per_step={k: v / n_steps for k, v in counts.items()})
    log("train BERT fp16: " + json.dumps(metrics))
    check(all(np.isfinite(s_["loss"]) for s_ in steps),
          "BERT fp16: non-finite loss")
    check(len(applied) == len(steps),
          f"BERT fp16: {len(steps) - len(applied)} steps after the forced "
          f"one were skipped")
    check(len(applied) >= 2 and applied[-1] < applied[0] - BERT_LOSS_FALL,
          f"BERT fp16: the loss did not fall by {BERT_LOSS_FALL} over the "
          f"applied steps {applied}")
    want = bert_launches_per_step(bcfg)
    want.update(l2norm_flat=0, adam_flat=0)
    for name, per_step in want.items():
        check(counts[name] == per_step * n_steps,
              f"BERT fp16: {name} launched {counts[name]} times, expected "
              f"{per_step} x {n_steps} steps")
    metrics["profile"] = phase_train_profile("BERT fp16", state, step_fn,
                                             (tok, tgt, mask))
    del state, step_fn
    torch.cuda.empty_cache()
    return metrics


# ---------------------------------------------------------------------------
# phase 24: ResNet-50 with FusedSGD (examples/imagenet_amp.py)
# ---------------------------------------------------------------------------

#: examples/imagenet_amp.py's defaults
RESNET_BATCH, RESNET_IMAGE, RESNET_LR = 64, 224, 0.1
#: sgd_flat kernel vs plain in fp32: the same expression, rounded in
#: another order (fused multiply-adds)
SGD_TOL = dict(atol=1e-6, rtol=1e-5)
#: flat vs tree FusedSGD on ResNet-50: the same update, rounded at other
#: places, and cuDNN's weight gradients are summed in an order that may
#: change between runs. At the example's lr 0.1 the loss on the repeated
#: random batch falls at the first update (6.94 to 4.79) and then climbs
#: (to about 19 by step 10, in fp32 compute too, while at lr 0.01 it
#: falls every step, on an H100), and on that climb the two layouts'
#: rounding differences grow (0.94 apart at step 10). So the layouts are
#: held over the first RESNET_HELD_STEPS steps (0.025 apart at most in
#: that run), the first step's losses, before any update, equal.
RESNET_LAYOUT_BAND = 5e-2
RESNET_HELD_STEPS = 4


def phase_sgd_kernel(rcfg):
    """``sgd_flat`` against its plain version on the card: one fp32 group
    of ResNet-50's padded size (momentum 0.9, weight decay 1e-4, as the
    step runs it), and a small bf16 group with Nesterov, a grad scale,
    the delta mode and ``skip``. Returns its row."""
    import inspect

    from apex_tpu_torch.kernels import (
        reset_launch_counts,
        sgd_flat,
        sgd_flat_plain,
    )
    from apex_tpu_torch.kernels.flat_ops import sgd_scalars
    from apex_tpu_torch.multi_tensor import pad_to

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(43)

    def group(n, dtype):
        p = (torch.randn(n, generator=g, device=dev) * 0.05).to(dtype)
        gr = torch.randn(n, generator=g, device=dev) * 1e-2
        m = torch.randn(n, generator=g, device=dev) * 1e-2
        return p, gr, m

    def sgd_both(p, gr, m, hp, **flags):
        pk, mk, pp, mp = p.clone(), m.clone(), p.clone(), m.clone()
        s = sgd_scalars(hp["lr"], hp["momentum"], hp["dampening"],
                        hp["weight_decay"], hp.get("grad_scale", 1.0), dev)
        ok, _ = sgd_flat([pk], [gr], [mk], **hp, **flags)
        op, _ = sgd_flat_plain([pp], [gr], [mp], s, **flags)
        torch.cuda.synchronize()
        return (ok[0], mk), (op[0], mp), (pk, p)

    errs = []
    hp = dict(lr=0.1, momentum=0.9, dampening=0.0, weight_decay=1e-4,
              grad_scale=0.5)
    for flags in (dict(nesterov=True), dict(out_is_delta=True), {}):
        p, gr, m = group(4 * 65536, torch.bfloat16)
        (ok, mk), (op, mp), (pk, p0) = sgd_both(p, gr, m, hp, **flags)
        # bf16 params: one rounding of the same fp32 result, one ulp
        pk_ok = (close(ok, op, SGD_TOL) if flags.get("out_is_delta")
                 else ulp_close(ok, op))
        check(pk_ok and close(mk, mp, SGD_TOL),
              f"sgd_flat bf16 {flags}: errs {max_err(ok, op)}, "
              f"{max_err(mk, mp)}")
        if flags.get("out_is_delta"):
            check(torch.equal(pk, p0), "sgd_flat delta mode changed p")
        errs.append(max_err(mk, mp))
    before = (pk.clone(), mk.clone())
    sgd_flat([pk], [gr], [mk], **hp,
             skip=torch.ones((), dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    check(torch.equal(pk, before[0]) and torch.equal(mk, before[1]),
          "sgd_flat: skip=True changed a buffer")

    n = pad_to(rcfg.param_count())
    p, gr, m = group(n, torch.float32)
    hp = dict(lr=RESNET_LR, momentum=0.9, dampening=0.0, weight_decay=1e-4)
    (ok, mk), (op, mp), _ = sgd_both(p, gr, m, hp)
    e = [max_err(ok, op), max_err(mk, mp)]
    check(close(ok, op, SGD_TOL) and close(mk, mp, SGD_TOL),
          f"sgd_flat n={n}: errs {e}")
    errs += e
    log(f"sgd_flat n={n} fp32: max|p,m - plain|={e} (tol atol=1e-6 "
        f"rtol=1e-5); bf16 groups with nesterov, delta mode and skip ok")
    del op, mp
    s = sgd_scalars(RESNET_LR, 0.9, 0.0, 1e-4, 1.0, dev)
    step_k = lambda: sgd_flat([ok], [gr], [mk], **hp)
    w = torch.nn.Parameter(p.clone())
    w.grad = gr.clone()
    fused = "fused" in inspect.signature(torch.optim.SGD).parameters
    lib = torch.optim.SGD([w], lr=RESNET_LR, momentum=0.9,
                          weight_decay=1e-4,
                          **({"fused": True} if fused else {"foreach": True}))
    lib.step()      # the first step only fills its momentum buffer
    # per element: read p, g, m and write p, m (fp32); ~6 flops
    sb, sby = bound(20 * n, 6 * n, FP32_FLOPS_PER_S)
    row = dict(
        name="sgd_flat", route="cuda",
        source="apex_tpu_torch/csrc/flat_ops.cu",
        replaces="apex_tpu/kernels/flat_ops.py:321",
        max_abs_err=max(errs), ms=time_ms(step_k, **TRAIN_TIMING),
        eager_ms=eager_ms(step_k, **TRAIN_TIMING),
        plain_ms=time_ms(lambda: sgd_flat_plain([p], [gr], [m], s),
                         **TRAIN_TIMING),
        bound_ms=sb, bound_by=sby,
        library_ms=eager_ms(lib.step, **TRAIN_TIMING),
        library=f"torch.optim.SGD({'fused' if fused else 'foreach'}=True)",
        shape=f"one fp32 group of n={n} (ResNet-50, padded)")
    log(f"kernel sgd_flat: {row['ms']:.4f} ms (eager {row['eager_ms']:.4f} "
        f"ms), plain {row['plain_ms']:.4f} ms, library "
        f"{row['library_ms']:.4f} ms ({row['library']}), bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']}) at {row['shape']}")
    del p, gr, m, ok, mk, w, lib
    torch.cuda.empty_cache()
    reset_launch_counts()
    return row


def resnet_batch():
    """The example's synthetic batch, regenerated with numpy: normal
    images of seed 1 (NHWC) and uniform labels of seed 2."""
    img = np.random.default_rng(1).standard_normal(
        (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3), dtype=np.float32)
    lbl = np.random.default_rng(2).integers(0, 1000, RESNET_BATCH)
    return (torch.as_tensor(img, device="cuda"),
            torch.as_tensor(lbl, device="cuda"))


def phase_resnet_train(rcfg, layout, images, labels):
    """``resnet.make_train_step`` with ``fused_sgd(0.1, momentum=0.9,
    weight_decay=1e-4, layout=layout)`` and the scaler of
    ``amp.initialize("O1", half_dtype=bfloat16)`` (none): one warm-up and
    ``TRAIN_STEPS`` timed steps, weights from seed 0, launch counts
    zeroed just before and read just after; then the example's eval leg,
    ``forward(training=False)`` top-1/top-5 on the batch. Returns
    (metrics, state)."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import resnet
    from apex_tpu_torch.optimizers import fused_sgd

    ctx, _ = amp.initialize(opt_level="O1", half_dtype=torch.bfloat16)
    init_fn, step_fn = resnet.make_train_step(
        rcfg, fused_sgd(RESNET_LR, momentum=0.9, weight_decay=1e-4,
                        layout=layout), ctx.scaler)
    state = init_fn(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    state, m = step_fn(state, images, labels)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        state, m = step_fn(state, images, labels)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        logits, _ = resnet.forward(rcfg, state.params, state.extra, images,
                                   training=False)
    top5 = logits.topk(5, dim=-1).indices
    hit1 = float((top5[:, 0] == labels).float().mean())
    hit5 = float((top5 == labels[:, None]).any(dim=1).float().mean())
    losses = [float(x) for x in losses]
    n_steps = TRAIN_STEPS + 1
    metrics = dict(
        layout=layout, images_per_sec=TRAIN_STEPS * RESNET_BATCH / wall,
        step_ms=wall / TRAIN_STEPS * 1e3, warmup_step_ms=warm * 1e3,
        peak_memory_bytes=peak, losses=losses, eval_top1=hit1,
        eval_top5=hit5, launches=counts,
        launches_per_step={k: v / n_steps for k, v in counts.items()})
    log(f"train ResNet-50 {layout}: " + json.dumps(metrics))
    check(tuple(logits.shape) == (RESNET_BATCH, rcfg.num_classes)
          and bool(torch.isfinite(logits).all()),
          f"ResNet {layout}: eval logits {tuple(logits.shape)} not finite")
    check(all(np.isfinite(losses)), f"ResNet {layout}: non-finite loss")
    check(abs(losses[0] - math.log(rcfg.num_classes)) < 1.0,
          f"ResNet {layout}: first loss {losses[0]} is not near ln(1000)")
    check(losses[1] < losses[0] - 0.1,
          f"ResNet {layout}: the first update did not lower the loss")
    want = n_steps if layout == "flat" else 0
    check(counts["sgd_flat"] == want,
          f"ResNet {layout}: sgd_flat launched {counts['sgd_flat']} times, "
          f"expected {want}")
    others = {k: v for k, v in counts.items() if k != "sgd_flat" and v}
    check(not others, f"ResNet {layout}: other kernels launched: {others}")
    return metrics, state


# ---------------------------------------------------------------------------
# phase 25: the head-major flash kernels vs plain
# ---------------------------------------------------------------------------

#: the 2.7B step's attention (``apex_tpu_torch.examples.gpt_train --preset
#: 2p7b``: batch 8 of seq 1024, 32 heads of 80, bf16, causal)
HM_BATCH, HM_HEADS, HM_SEQ, HM_DIM = 8, 32, 1024, 80
#: float16 through the public API at a head width off a multiple of 8
#: (d 100, widened): the fp32 kernels' output rounded to fp16 against the
#: plain version's, about one fp16 ulp (2^-10 relative)
F16_TOL = dict(atol=2e-3, rtol=2e-3)


#: the sequence at which JAX's rule picks the split backward by itself:
#: the fused sweep's fp32 dQ accumulator (16384 x 128 x 4 bytes) passes
#: its 4 MiB budget
AUTO_SPLIT_SEQ = 16384


def hm_grad_tol(ref: torch.Tensor) -> dict:
    """The head-major backward's fp32 gradients, kernel vs plain or fused
    vs split: the same fp32 products summed in another order (dQ by
    atomics in the fused kernel); 1e-4 of the reference's largest entry
    plus FP32_TOL's rtol."""
    return dict(atol=1e-4 * max(float(ref.abs().max()), 1.0),
                rtol=FP32_TOL["rtol"])


def _hm_inputs(dev, bh, sq, sk, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda s: torch.randn(bh, s, d, generator=g, device=dev,
                               dtype=torch.float32).to(dtype)
    return mk(sq), mk(sk), mk(sk), mk(sq)


def _hm_f16_public_api():
    """Phase 25's fp16 through the public API, with
    ``flash_attention_with_lse``'s lse cotangent through autograd: the
    tensor-core kernels at d 64, 80 and 128 (P and dS rounded to fp16)
    against the rounding twins (F16_TC_TOL, F16_BWD_TC_TOL), timed beside
    the fp32 route on the widened inputs, plain and fp16 SDPA; d 100
    widened to the fp32 CUDA-core kernels (F16_TOL); the split dQ and
    dK/dV sweeps on fp16 as it is (their tensor-core kernels), held and
    timed the same way. Returns (the fp16 rows by name and width, the
    tensor-core launches, the backwards' worst errors — the split sweeps'
    under "split" — and the forward's atol needed)."""
    from apex_tpu_torch.kernels import (
        flash_attention_bwd,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_plain,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_fwd_plain,
        flash_attention_with_lse,
        launch_counts,
        reset_launch_counts,
    )
    from apex_tpu_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda")
    f16 = torch.float16
    split_names = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
    f16_rows = {"flash_attention": {}, "flash_attention_bwd": {},
                **{name: {} for name in split_names}}
    f16_seen, f16_atol = {"split": {}}, {"tc": 0.0, "cuda_core": 0.0}
    f16_tc = dict.fromkeys(f16_rows, 0)
    for d in (64, 80, 100, 128):
        tc = d % 8 == 0
        b_, h_, s_ = 2, 2, 136
        bh_ = b_ * h_
        q, k, v, do = (t.view(b_, h_, s_, d) for t in _hm_inputs(
            dev, bh_, s_, s_, d, f16, seed=100 + d))
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        reset_launch_counts()
        out, lse = flash_attention_with_lse(qg, kg, vg, causal=True)
        check(out.dtype == f16, f"hm fp16 d={d}: out {out.dtype}")
        g = torch.Generator(device=dev).manual_seed(d)
        dlse = torch.randn(b_, h_, s_, generator=g, device=dev)
        torch.autograd.backward((out, lse), (do, dlse))
        counts = launch_counts()
        check_tc(f"hm fp16 d={d}", counts, "flash_attention", want=int(tc))
        check_tc(f"hm fp16 d={d} bwd", counts, "flash_attention_bwd",
                 want=int(tc))
        for name in ("flash_attention", "flash_attention_bwd"):
            f16_tc[name] += counts[f"{name}_tc"]
        out, lse = out.detach(), lse.detach()
        # the twins on what the ops take: fp16 as it is on the tensor
        # cores, widened to fp32 off them
        flat = lambda t: t.reshape(bh_, s_, d)
        qf, kf, vf, dof = (flat(t) if tc else flat(t).float()
                           for t in (q, k, v, do))
        ref, ref_lse = flash_attention_fwd_plain(qf, kf, vf, causal=True)
        side = "tc" if tc else "cuda_core"
        f16_atol[side] = max(f16_atol[side], atol_needed(
            flat(out), ref.half(), F16_TC_TOL["rtol"]))
        check(close(flat(out), ref.half(), F16_TC_TOL if tc else F16_TOL)
              and close(lse, ref_lse.view(b_, h_, s_), FP32_TOL),
              f"hm fp16 d={d}: out err {max_err(flat(out), ref)}, lse err "
              f"{max_err(lse.view(bh_, s_), ref_lse)}")
        # delta as the autograd formula takes it: from the op's own out
        # (fp16 on the tensor cores, the fp32 kernel's off them)
        delta = ((flat(out) if tc else ref).float() * dof.float()).sum(-1) \
            - dlse.view(bh_, s_)
        lse_f = lse.view(bh_, s_)
        want = flash_attention_bwd_plain(qf, kf, vf, dof, lse_f, delta,
                                         causal=True)
        got = [flat(t.grad) for t in (qg, kg, vg)]
        check(all(a.dtype == f16 for a in got), f"hm fp16 d={d}: grad dtype")
        if tc:
            # the op's fp32 gradients reach the caller rounded to fp16
            hold_bwd_tc(f"hm fp16 d={d}", got, [w.half() for w in want],
                        f16_seen, tol=F16_BWD_TC_TOL)
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            check(tc or close(a, w, dict(
                atol=F16_TOL["atol"] * max(float(w.abs().max()), 1.0),
                rtol=F16_TOL["rtol"])),
                f"hm fp16 d={d}: {name} err {max_err(a, w)}")
        # the public out-only call is the same forward
        check(torch.equal(flash_attention(q, k, v, causal=True), out),
              f"hm fp16 d={d}: flash_attention != flash_attention_with_lse")
        if not tc:
            continue
        # the split sweeps take fp16 as it is: their tensor-core kernels
        # round P and dS to fp16, as the fused one and the twins do
        args = (qf, kf, vf, dof, lse_f, delta)
        reset_launch_counts()
        split = (flash_attention_bwd_dq(*args, causal=True),
                 *flash_attention_bwd_dkdv(*args, causal=True))
        counts = launch_counts()
        for name in split_names:
            check_tc(f"hm fp16 d={d} split", counts, name, want=1)
            f16_tc[name] += counts[f"{name}_tc"]
        hold_bwd_tc(f"hm fp16 d={d} split", split, want, f16_seen["split"],
                    tol=F16_BWD_TC_TOL)
        split_err = max(max_err(a, w) for a, w in zip(split, want))
        # timed: the kernels, the fp32 route on the widened inputs (what
        # fp16 ran before, casts included), plain, fp16 SDPA, the bound
        wide = [t.float() for t in args[:4]] + [lse_f, delta]
        lib_q, lib_k, lib_v = (t.detach().requires_grad_(True)
                               for t in (q, k, v))
        lib_f = lambda: F.scaled_dot_product_attention(lib_q, lib_k, lib_v,
                                                       is_causal=True)

        def lib_grad(*wrt):
            def run():
                o = F.scaled_dot_product_attention(lib_q, lib_k, lib_v,
                                                   is_causal=True)
                torch.autograd.grad(o, wrt, do)
            return run

        lib_f_ms = time_ms(lib_f)
        pairs = bh_ * s_ * (s_ + 1) / 2
        act, stats = bh_ * s_ * d * 2, bh_ * s_ * 4
        shape = f"b={b_} heads={h_} s={s_} d={d} fp16 causal"
        for name, fn, prev, plain, lib, n_bytes, n_flops, err in (
                ("flash_attention",
                 lambda: flash_attention_fwd(qf, kf, vf, causal=True),
                 lambda: flash_attention_fwd(*(t.float() for t in args[:3]),
                                             causal=True)[0].half(),
                 lambda: flash_attention_fwd_plain(qf, kf, vf, causal=True),
                 lib_f_ms, 4 * act + stats, 4 * d * pairs,
                 max_err(flat(out), ref)),
                ("flash_attention_bwd",
                 lambda: flash_attention_bwd(*args, causal=True),
                 lambda: [t.half() for t in flash_attention_bwd(
                     *(t.float() for t in args[:4]), lse_f, delta,
                     causal=True)],
                 lambda: flash_attention_bwd_plain(*args, causal=True),
                 # fp16 q, k, v, do in; fp32 dq, dk, dv out
                 time_ms(lib_grad(lib_q, lib_k, lib_v)) - lib_f_ms,
                 4 * act + 3 * 2 * act + 2 * stats, 5 * 2 * d * pairs,
                 max(max_err(a, w) for a, w in zip(got, want))),
                ("flash_attention_bwd_dq",
                 lambda: flash_attention_bwd_dq(*args, causal=True),
                 lambda: flash_attention_bwd_dq(*wide, causal=True).half(),
                 lambda: flash_attention_bwd_dq_plain(*args, causal=True),
                 time_ms(lib_grad(lib_q)) - lib_f_ms,
                 4 * act + 2 * act + 2 * stats, 3 * 2 * d * pairs,
                 split_err),
                ("flash_attention_bwd_dkdv",
                 lambda: flash_attention_bwd_dkdv(*args, causal=True),
                 lambda: [t.half() for t in flash_attention_bwd_dkdv(
                     *wide, causal=True)],
                 lambda: flash_attention_bwd_dkdv_plain(*args, causal=True),
                 time_ms(lib_grad(lib_k, lib_v)) - lib_f_ms,
                 4 * act + 2 * 2 * act + 2 * stats, 4 * 2 * d * pairs,
                 split_err)):
            bnd, by = bound(n_bytes, n_flops)
            f16_rows[name][f"d{d}"] = dict(
                ms=time_ms(fn), prev_ms=time_ms(prev), plain_ms=time_ms(plain),
                library_ms=lib, bound_ms=bnd, bound_by=by, max_abs_err=err,
                shape=shape)
        del lib_q, lib_k, lib_v
    log(f"head-major fp16 through the public API: the tensor-core kernels "
        f"(d 64/80/128) out needs atol {f16_atol['tc']:.3e} at rtol 2^-10 "
        f"(F16_TC_TOL {F16_TC_TOL}; d 100 on the CUDA cores "
        f"{f16_atol['cuda_core']:.3e}), the fused backward (atol_rel, rms) "
        f"{f16_seen['tc']}, the split sweeps {f16_seen['split']['tc']} "
        f"(F16_BWD_TC_TOL {F16_BWD_TC_TOL}); {f16_tc} tensor-core "
        f"launches")
    for name, by_d in f16_rows.items():
        for key, r in by_d.items():
            log(f"kernel {name} (fp16 {key}): {r['ms']:.4f} ms, the fp32 "
                f"route {r['prev_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"library {r['library_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.5f} ms ({r['bound_by']}) at {r['shape']}")
    return f16_rows, f16_tc, f16_seen, f16_atol


def _hm_auto_split(split_vs_fused: dict, split_equal: dict) -> dict:
    """Phase 25: with ``APEX_TPU_FLASH_BWD`` unset, causal s = 16384,
    batch 1, 4 heads of 64 and of 80, bf16, through ``flash_attention``
    and autograd. JAX's rule picks the split backward there by itself
    (``fused_backward``), so one split dQ and one split dK/dV launch run,
    both on the tensor cores, and no fused one; their gradients are held
    against the fused tensor-core kernel's under
    ``APEX_TPU_FLASH_BWD=fused`` on the same inputs (BWD_TC_TOL; dK and dV
    bit for bit), not against the plain twin,
    which would hold s² scores. Returns the split sweeps' launches (and
    their tensor-core share) over both widths."""
    import os

    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.kernels.flash_attention import (
        flash_attention,
        fused_backward,
    )

    check("APEX_TPU_FLASH_BWD" not in os.environ,
          "auto split: APEX_TPU_FLASH_BWD is set")
    dev = torch.device("cuda")
    s, h = AUTO_SPLIT_SEQ, 4
    split = ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
    want = {"auto": {"flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
                     **{n: 1 for n in split},
                     **{f"{n}_tc": 1 for n in split}},
            "fused": {"flash_attention_bwd": 1, "flash_attention_bwd_tc": 1,
                      **{n: 0 for n in split}}}
    total = dict.fromkeys(want["auto"], 0)
    for d in (64, 80):
        check(not fused_backward(s, d),
              f"auto split: the rule picks the fused backward at s={s} d={d}")
        q, k, v, do = (t.view(1, h, s, d) for t in _hm_inputs(
            dev, h, s, s, d, torch.bfloat16, seed=160 + d))
        grads = {}
        for mode in ("auto", "fused"):
            if mode == "fused":
                os.environ["APEX_TPU_FLASH_BWD"] = "fused"
            try:
                qg, kg, vg = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                reset_launch_counts()
                torch.autograd.backward(
                    flash_attention(qg, kg, vg, causal=True), do)
                torch.cuda.synchronize()
                counts = launch_counts()
            finally:
                os.environ.pop("APEX_TPU_FLASH_BWD", None)
            grads[mode] = [t.grad for t in (qg, kg, vg)]
            for name, n in want[mode].items():
                check(counts[name] == n, f"auto split s={s} d={d} {mode}: "
                      f"{name} launched {counts[name]} times, expected {n}")
            if mode == "auto":
                for name in total:
                    total[name] += counts[name]
        tag = f"auto split s={s} d={d}"
        hold_bwd_tc(f"{tag} vs fused", grads["auto"], grads["fused"],
                    split_vs_fused)
        same = all(torch.equal(a, b) for a, b in zip(grads["auto"][1:],
                                                     grads["fused"][1:]))
        split_equal["cases"] += 1
        split_equal["equal"] += int(same)
        check(same, f"{tag}: split dk/dv differ from the fused kernel's")
        log(f"{tag}: split == fused dk/dv {same}; dq, dk, dv max |split - "
            f"fused| {[max_err(a, b) for a, b in zip(grads['auto'], grads['fused'])]}")
        del q, k, v, do, grads
    torch.cuda.empty_cache()
    return total


def phase_hm_kernels():
    """Phase 25: the head-major forward, fused backward and split dQ /
    dK-dV against their plain versions — at small ragged shapes (fp32,
    bf16 and fp16 through the public API; d 64, 80, 128; sq != sk;
    kv lengths with a 0; segment ids; ``flash_attention_with_lse`` with a
    nonzero lse cotangent) and at the 2.7B step's shape, with fused ==
    split and the split kernels bit-equal across two launches; timed as
    phase 3 does. The bf16 backwards, fused and split, run the tensor
    cores and are held to BWD_TC_TOL against the rounding twins, beside
    the CUDA-core kernels on the same inputs; the CUDA-core kernels, which
    keep P and dS in fp32, are held to the twins on the inputs widened to
    fp32. Then the backward JAX's rule picks by itself at s = 16384
    (``_hm_auto_split``). Returns ``{name: row}``."""
    from apex_tpu_torch.kernels import (
        flash_attention_bwd,
        flash_attention_bwd_dkdv,
        flash_attention_bwd_dkdv_plain,
        flash_attention_bwd_dq,
        flash_attention_bwd_dq_plain,
        flash_attention_bwd_plain,
        flash_attention_fwd,
        flash_attention_fwd_plain,
        flash_attention_with_lse,
        launch_counts,
        reset_launch_counts,
    )
    from apex_tpu_torch.kernels.flash_attention import flash_attention

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    worst = {"fwd": 0.0, "fused": 0.0, "dq": 0.0, "dkdv": 0.0}
    # the forward by kernel: the tensor-core one (bf16) and the CUDA-core
    # one (fp32; bf16 at d=100)
    worst_fwd = {"tc": 0.0, "tc_lse": 0.0, "tc_atol": 0.0, "cuda_core": 0.0}
    # the bf16 fused backward against the rounding twins: the tensor-core
    # kernel, and the CUDA-core one on the same inputs; the same for the
    # split sweeps, and the split tensor-core sweeps against the fused one
    seen, seen_split, split_vs_fused = {}, {}, {}
    split_equal = {"equal": 0, "cases": 0}

    def hold(tag, q, k, v, do, *, causal, n_rep, lens=None, segs=None,
             dlse=None, tc=None):
        """Forward, fused backward and split sweeps (on the tensor-core
        kernels iff ``tc``, by default iff bf16) against plain: the
        rounding twins on the tensor cores (beside the CUDA-core kernels
        on the same inputs, measured) and the widened twins on the CUDA
        cores; fused vs split, within BWD_TC_TOL on the tensor cores (dK
        and dV bit for bit) and within
        hm_grad_tol on the CUDA cores; the split kernels bit-equal across
        two launches."""
        kw = dict(causal=causal, lens=lens, segs=segs, n_rep=n_rep)
        tc = q.dtype == bf16 if tc is None else tc
        reset_launch_counts()
        out, lse = flash_attention_fwd(q, k, v, **kw)
        check_tc(tag, launch_counts(), "flash_attention", want=int(tc))
        ref, ref_lse = flash_attention_fwd_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = TC_TOL if tc else BF16_TOL if q.dtype == bf16 else FP32_TOL
        check(bool(torch.isfinite(out).all()), f"{tag}: non-finite out")
        check(close(out, ref, tol) and close(lse, ref_lse, FP32_TOL),
              f"{tag}: fwd out err {max_err(out, ref)}, lse err "
              f"{max_err(lse, ref_lse)}")
        worst["fwd"] = max(worst["fwd"], max_err(out, ref))
        if tc:
            worst_fwd["tc"] = max(worst_fwd["tc"], max_err(out, ref))
            worst_fwd["tc_lse"] = max(worst_fwd["tc_lse"],
                                      max_err(lse, ref_lse))
            worst_fwd["tc_atol"] = max(worst_fwd["tc_atol"], atol_needed(
                out, ref, TC_TOL["rtol"]))
        else:
            worst_fwd["cuda_core"] = max(worst_fwd["cuda_core"],
                                         max_err(out, ref))
        delta = (out.float() * do.float()).sum(-1)
        if dlse is not None:
            delta = delta - dlse
        args = (q, k, v, do, lse, delta.contiguous())
        # the CUDA-core kernels' twin: P and dS in fp32
        wide = tuple(t.float() for t in args[:4]) + args[4:]
        want = flash_attention_bwd_plain(*(args if tc else wide), **kw)
        reset_launch_counts()
        fused = flash_attention_bwd(*args, **kw)
        check_tc(f"{tag} bwd", launch_counts(), "flash_attention_bwd",
                 want=int(tc))
        dq = flash_attention_bwd_dq(*args, **kw)
        dk, dv = flash_attention_bwd_dkdv(*args, **kw)
        dq2 = flash_attention_bwd_dq(*args, **kw)
        dk2, dv2 = flash_attention_bwd_dkdv(*args, **kw)
        counts = launch_counts()
        for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkdv"):
            check_tc(f"{tag} split", counts, name, want=2 * int(tc))
        # the split sweeps' twins: rounding on the tensor cores, widened
        # on the CUDA cores
        split_want = want if tc else (
            flash_attention_bwd_dq_plain(*wide, **kw),
            *flash_attention_bwd_dkdv_plain(*wide, **kw))
        torch.cuda.synchronize()
        if tc:
            hold_bwd_tc(f"{tag}: fused", fused, want, seen)
            _, cc = hm_bwd_cuda_core(*args, **kw)
            _, cc_dq = hm_bwd_cuda_core(*args, **kw, entry="dq")
            _, cc_kv = hm_bwd_cuda_core(*args, **kw, entry="dkdv")
            torch.cuda.synchronize()
            hold_bwd_tc(tag, cc, want, seen, side="cuda_core")
            hold_bwd_tc(f"{tag}: split", (dq, dk, dv), want, seen_split)
            hold_bwd_tc(tag, (cc_dq[0], cc_kv[1], cc_kv[2]), want,
                        seen_split, side="cuda_core")
            # split vs fused, both on the tensor cores
            hold_bwd_tc(f"{tag}: split vs fused", (dq, dk, dv), fused,
                        split_vs_fused)
            same = torch.equal(dk, fused[1]) and torch.equal(dv, fused[2])
            split_equal["cases"] += 1
            split_equal["equal"] += int(same)
            # the split dK/dV sweep is the fused body less its dQ share,
            # on tiles of its own that change no sum (csrc/flash_bwd_tc.cu,
            # launch_dkdv): its dK and dV are the fused kernel's bits
            check(same, f"{tag}: split dk/dv differ from the fused kernel's by "
                  f"{max(max_err(dk, fused[1]), max_err(dv, fused[2]))}")
        for name, a, w in zip(("dq", "dk", "dv"), fused, want):
            check(bool(torch.isfinite(a).all()), f"{tag}: non-finite {name}")
            check(tc or close(a, w, hm_grad_tol(w)),
                  f"{tag}: fused {name} err {max_err(a, w)}")
            worst["fused"] = max(worst["fused"], max_err(a, w))
        for name, a, w, f_ in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                  split_want, fused):
            key = "dq" if name == "dq" else "dkdv"
            check(bool(torch.isfinite(a).all()),
                  f"{tag}: non-finite split {name}")
            check(tc or close(a, w, hm_grad_tol(w)),
                  f"{tag}: split {name} err {max_err(a, w)}")
            check(tc or close(a, f_, hm_grad_tol(w)),
                  f"{tag}: split and fused {name} differ by {max_err(a, f_)}")
            worst[key] = max(worst[key], max_err(a, w))
        check(torch.equal(dq, dq2) and torch.equal(dk, dk2)
              and torch.equal(dv, dv2),
              f"{tag}: the split kernels differ between two launches")
        return out, lse

    # -- small ragged shapes: every head width, both kernel dtypes
    for dtype in (f32, bf16):
        for d in (64, 80, 128):
            b_, h_ = 2, 3
            bh = b_ * h_
            hold(f"hm {dtype} d={d} causal s=200",
                 *_hm_inputs(dev, bh, 200, 200, d, dtype, seed=d),
                 causal=True, n_rep=h_)
            q, k, v, do = _hm_inputs(dev, bh, 72, 130, d, dtype, seed=d + 1)
            lens = torch.tensor([0, 130, 57], dtype=torch.int32,
                                device=dev).repeat_interleave(2)
            g = torch.Generator(device=dev).manual_seed(d)
            segs = (torch.randint(0, 3, (b_, 72), generator=g, device=dev,
                                  dtype=torch.int32),
                    torch.randint(0, 3, (b_, 130), generator=g, device=dev,
                                  dtype=torch.int32))
            out, lse = hold(f"hm {dtype} d={d} sq=72 sk=130 lens+segs",
                            q, k, v, do, causal=False, n_rep=h_, lens=lens,
                            segs=segs)
            # the rows of a kv length 0: every column masked
            check(bool((out[lens == 0] == 0).all()),
                  f"hm {dtype} d={d}: a kv length of 0 gave a nonzero out")
            check(bool((lse[lens == 0] == -1e30 + math.log(1e-30)).all()),
                  f"hm {dtype} d={d}: lse of a kv length 0 is "
                  f"{float(lse[lens == 0].max())}")
            hold(f"hm {dtype} d={d} causal s=65 segs",
                 *_hm_inputs(dev, bh, 65, 65, d, dtype, seed=d + 2),
                 causal=True, n_rep=h_,
                 segs=(segs[0][:, :65].contiguous(),
                       segs[0][:, :65].contiguous()))
            g = torch.Generator(device=dev).manual_seed(d + 3)
            hold(f"hm {dtype} d={d} with dlse",
                 *_hm_inputs(dev, bh, 96, 96, d, dtype, seed=d + 3),
                 causal=True, n_rep=h_,
                 dlse=torch.randn(bh, 96, generator=g, device=dev))

    # -- the kernel choice at its edges: d=32 and d=72 (tensor cores,
    #    padded to 64 and 80), d=100 (CUDA cores), a bf16 operand off a 16-byte boundary
    #    (tensor cores, after one copy), and rows whose segment id no key
    #    has (every column masked: out 0, lse -1e30 + log(1e-30), and no
    #    gradient from them)
    b_, h_ = 2, 3
    bh = b_ * h_
    for d, tc in ((32, True), (72, True), (100, False)):
        hold(f"hm bf16 d={d} causal s=200",
             *_hm_inputs(dev, bh, 200, 200, d, bf16, seed=d), causal=True,
             n_rep=h_, tc=tc)
        lens = torch.tensor([57, 0, 130], dtype=torch.int32,
                            device=dev).repeat_interleave(2)
        hold(f"hm bf16 d={d} sq=72 sk=130 lens",
             *_hm_inputs(dev, bh, 72, 130, d, bf16, seed=d + 1),
             causal=False, n_rep=h_, lens=lens, tc=tc)
    q, k, v, do = _hm_inputs(dev, bh, 72, 130, 64, bf16, seed=5)
    buf = torch.empty(q.numel() + 8, dtype=bf16, device=dev)
    qu = buf[1:1 + q.numel()].view_as(q)
    qu.copy_(q)
    check(qu.data_ptr() % 16 != 0, "hm: the unaligned q is aligned")
    hold("hm bf16 d=64 q off a 16-byte boundary", qu, k, v, do,
         causal=False, n_rep=h_)
    g = torch.Generator(device=dev).manual_seed(9)
    seg_q = torch.randint(0, 3, (b_, 72), generator=g, device=dev,
                          dtype=torch.int32)
    seg_k = torch.randint(0, 3, (b_, 130), generator=g, device=dev,
                          dtype=torch.int32)
    seg_q[:, :5] = 7                      # an id no key carries
    for d in (64, 80, 128):
        q, k, v, do = _hm_inputs(dev, bh, 72, 130, d, bf16, seed=d + 7)
        out, lse = hold(f"hm bf16 d={d} all-masked rows", q, k, v, do,
                        causal=False, n_rep=h_, segs=(seg_q, seg_k))
        dead = (seg_q[:, :5] == 7).repeat_interleave(h_, 0)
        check(bool((out[:, :5][dead] == 0).all())
              and bool((lse[:, :5] == -1e30 + math.log(1e-30)).all()),
              f"hm bf16 d={d}: an all-masked row gave out "
              f"{float(out[:, :5].abs().max())}, lse "
              f"{float(lse[:, :5].max())}")
    log(f"head-major forward by kernel (small shapes): tensor cores "
        f"max|out-plain| {worst_fwd['tc']:.3e} (TC_TOL), max|lse-plain| "
        f"{worst_fwd['tc_lse']:.3e} (1e-3); CUDA cores max|out-plain| "
        f"{worst_fwd['cuda_core']:.3e}; the bf16 backwards against the "
        f"rounding twins, worst (atol_rel, rms): fused on the tensor cores "
        f"{seen['tc']}, on the CUDA cores {seen['cuda_core']}; split on the "
        f"tensor cores {seen_split['tc']}, on the CUDA cores "
        f"{seen_split['cuda_core']} (BWD_TC_TOL {BWD_TC_TOL}); split vs "
        f"fused on the tensor cores {split_vs_fused['tc']}, dK and dV bit "
        f"for bit in {split_equal['equal']} of {split_equal['cases']} cases")

    f16_rows, f16_tc, f16_seen, f16_atol = _hm_f16_public_api()
    auto_launches = _hm_auto_split(split_vs_fused, split_equal)
    log(f"head-major kernels at small shapes (fp32/bf16 x d 64/80/128, "
        f"causal, sq != sk, lens with a 0, segments, dlse; fp16 public API):"
        f" max|kernel - plain| {worst}")

    # -- the 2.7B step's shape
    b, h, s, d = HM_BATCH, HM_HEADS, HM_SEQ, HM_DIM
    bh = b * h
    worst_small = dict(worst)
    for key in worst:
        worst[key] = 0.0
    q, k, v, do = _hm_inputs(dev, bh, s, s, d, bf16, seed=27)
    kw = dict(causal=True, n_rep=h)
    out, lse = hold(f"hm 2.7B shape b={b} h={h} s={s} d={d} bf16", q, k, v,
                    do, **kw)
    delta = (out.float() * do.float()).sum(-1).contiguous()
    args = (q, k, v, do, lse, delta)
    # the fused backward at this shape: tensor cores against the CUDA-core
    # kernel it took over from, which must miss BWD_TC_TOL
    step = {}
    want = flash_attention_bwd_plain(*args, **kw)
    hold_bwd_tc("hm 2.7B fused", flash_attention_bwd(*args, **kw), want,
                step)
    cc_launch, cc = hm_bwd_cuda_core(*args, **kw)
    torch.cuda.synchronize()
    hold_bwd_tc("hm 2.7B fused", cc, want, step, side="cuda_core")
    check_cc_fails("hm 2.7B fused", cc, want)
    del cc
    # the split sweeps likewise: tensor cores against the CUDA-core
    # kernels they took over from, launched by their entries
    step_split = {}
    hold_bwd_tc("hm 2.7B split", (flash_attention_bwd_dq(*args, **kw),
                                  *flash_attention_bwd_dkdv(*args, **kw)),
                want, step_split)
    cc_dq_launch, cc_dq = hm_bwd_cuda_core(*args, **kw, entry="dq")
    cc_kv_launch, cc_kv = hm_bwd_cuda_core(*args, **kw, entry="dkdv")
    torch.cuda.synchronize()
    cc_split = (cc_dq[0], cc_kv[1], cc_kv[2])
    hold_bwd_tc("hm 2.7B split", cc_split, want, step_split,
                side="cuda_core")
    check_cc_fails("hm 2.7B split", cc_split, want)
    del want, cc_dq, cc_kv, cc_split
    hv = lambda t: t.view(b, h, s, d)
    qh, kh, vh = (hv(t).detach().requires_grad_(True) for t in (q, k, v))
    lib_fwd = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                     is_causal=True)

    def lib_grad(*wrt):
        def run():
            o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            torch.autograd.grad(o, wrt, hv(do))
        return run

    lib_fwd_ms = time_ms(lib_fwd, **TRAIN_TIMING)
    pairs = bh * s * (s + 1) / 2                 # causal (row, key) pairs
    act = bh * s * d * 2                         # one bf16 [bh, s, d]
    act32 = bh * s * d * 4                       # one fp32 gradient
    stats = bh * s * 4                           # one fp32 [bh, s]
    shape = f"b={b} heads={h} s={s} d={d} bf16 causal"
    rows = {}

    def row(name, src, line, fn, plain, lib, n_bytes, n_flops, err):
        bnd, by = bound(n_bytes, n_flops)
        rows[name] = dict(
            name=name, route="cuda", source=f"apex_tpu_torch/csrc/{src}",
            replaces=f"apex_tpu/kernels/flash_attention.py:{line}",
            max_abs_err=err, ms=time_ms(fn, **TRAIN_TIMING),
            eager_ms=eager_ms(fn, **TRAIN_TIMING),
            plain_ms=time_ms(plain, **TRAIN_TIMING), bound_ms=bnd,
            bound_by=by, library_ms=lib, shape=shape)

    row("flash_attention", "flash_fwd_tc.cu", 393,
        lambda: flash_attention_fwd(q, k, v, **kw),
        lambda: flash_attention_fwd_plain(q, k, v, **kw),
        lib_fwd_ms, 4 * act + stats,
        4 * d * pairs, worst_fwd["tc"])
    # the CUDA-core kernel it took over from, on the same inputs: still
    # built in bf16 (d=100), launched here directly
    from apex_tpu_torch.kernels import _build
    cc_out = torch.empty_like(q)
    cc_lse = torch.empty((bh, s), dtype=f32, device=dev)

    def cuda_core():
        _build.check(_build.library().apex_tpu_torch_flash_fwd_hm(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, None, None,
            cc_out.data_ptr(), cc_lse.data_ptr(), bh, h, s, s, d,
            1.0 / d ** 0.5, 1, _build.DTYPE_CODES[bf16], _build.stream()),
            "flash_attention (CUDA cores)")

    rows["flash_attention"].update(
        variant=TC_VARIANT["flash_attention"], max_lse_err=worst_fwd["tc_lse"],
        prev_ms=time_ms(cuda_core, **TRAIN_TIMING),
        prev_ms_source="measured in this run: csrc/flash_attention.cu's bf16 "
                       "kernel on the same inputs")
    # what TC_TOL holds: the CUDA-core kernel keeps P in fp32, and needs a
    # larger atol against the twins (which round P) than the new kernel
    ref, _ = flash_attention_fwd_plain(q, k, v, **kw)
    cc_atol = atol_needed(cc_out, ref, TC_TOL["rtol"])
    del ref
    log(f"kernel flash_attention (2.7B shape): tensor cores "
        f"{rows['flash_attention']['ms']:.4f} ms, the CUDA-core kernel "
        f"{rows['flash_attention']['prev_ms']:.4f} ms in this run ("
        f"{rows['flash_attention']['prev_ms'] / rows['flash_attention']['ms']:.1f}"
        f"x); the atol each needs against plain at TC_TOL's rtol 2^-7: "
        f"tensor cores {worst_fwd['tc_atol']:.3e} (any shape of this phase; "
        f"TC_TOL's atol {TC_TOL['atol']}), CUDA cores {cc_atol:.3e}")
    del cc_out, cc_lse
    # the fused backward: S, dP, dV, dK and dQ over the causal pairs
    row("flash_attention_bwd", "flash_bwd_tc.cu", 514,
        lambda: flash_attention_bwd(*args, **kw),
        lambda: flash_attention_bwd_plain(*args, **kw),
        time_ms(lib_grad(qh, kh, vh), **TRAIN_TIMING) - lib_fwd_ms,
        4 * act + 3 * act32 + 2 * stats, 5 * 2 * d * pairs,
        max(worst["fused"], worst_small["fused"]))
    rows["flash_attention_bwd"].update(
        variant=TC_BWD_VARIANT["flash_attention_bwd"],
        prev_ms=time_ms(cc_launch, **TRAIN_TIMING),
        prev_ms_source="measured in this run: csrc/flash_attention_bwd.cu's "
                       "fused bf16 kernel on the same inputs",
        tol=dict(BWD_TC_TOL, tc=seen["tc"], cuda_core=seen["cuda_core"],
                 step_tc=step["tc"], step_cuda_core=step["cuda_core"]))
    del cc_launch
    log(f"kernel flash_attention_bwd (2.7B shape): tensor cores "
        f"{rows['flash_attention_bwd']['ms']:.4f} ms, the CUDA-core kernel "
        f"{rows['flash_attention_bwd']['prev_ms']:.4f} ms in this run; "
        f"(atol_rel, rms) against the rounding twin: tensor cores "
        f"{step['tc']}, CUDA cores {step['cuda_core']}")
    # the split dQ sweep: S, dP and dQ; its library time is SDPA's
    # backward asked for dq alone (the call computes all three)
    row("flash_attention_bwd_dq", "flash_bwd_dq_tc.cu", 547,
        lambda: flash_attention_bwd_dq(*args, **kw),
        lambda: flash_attention_bwd_dq_plain(*args, **kw),
        time_ms(lib_grad(qh), **TRAIN_TIMING) - lib_fwd_ms,
        4 * act + act32 + 2 * stats, 3 * 2 * d * pairs,
        max(worst["dq"], worst_small["dq"]))
    # the split dK/dV sweep: S, dP, dV and dK
    row("flash_attention_bwd_dkdv", "flash_bwd_tc.cu", 569,
        lambda: flash_attention_bwd_dkdv(*args, **kw),
        lambda: flash_attention_bwd_dkdv_plain(*args, **kw),
        time_ms(lib_grad(kh, vh), **TRAIN_TIMING) - lib_fwd_ms,
        4 * act + 2 * act32 + 2 * stats, 4 * 2 * d * pairs,
        max(worst["dkdv"], worst_small["dkdv"]))
    for name, launch, entry in (
            ("flash_attention_bwd_dq", cc_dq_launch, "dQ"),
            ("flash_attention_bwd_dkdv", cc_kv_launch, "dK/dV")):
        rows[name].update(
            variant=TC_BWD_VARIANT[name],
            prev_ms=time_ms(launch, **TRAIN_TIMING),
            prev_ms_source=f"measured in this run: csrc/flash_attention_"
                           f"bwd.cu's split {entry} bf16 kernel on the same "
                           f"inputs",
            tol=dict(BWD_TC_TOL, tc=seen_split["tc"],
                     cuda_core=seen_split["cuda_core"],
                     step_tc=step_split["tc"],
                     step_cuda_core=step_split["cuda_core"],
                     split_vs_fused=split_vs_fused["tc"],
                     dkdv_bit_equal_to_fused=dict(split_equal)),
            launches_auto_split=auto_launches[name],
            launches_tc_auto_split=auto_launches[f"{name}_tc"])
        log(f"kernel {name} (2.7B shape): tensor cores "
            f"{rows[name]['ms']:.4f} ms, the CUDA-core kernel "
            f"{rows[name]['prev_ms']:.4f} ms in this run "
            f"({rows[name]['prev_ms'] / rows[name]['ms']:.1f}x); "
            f"(atol_rel, rms) against the rounding twin: tensor cores "
            f"{step_split['tc']}, CUDA cores {step_split['cuda_core']}")
    del cc_dq_launch, cc_kv_launch
    del q, k, v, do, out, lse, delta, args, qh, kh, vh
    log(f"head-major kernels at the 2.7B shape: max|kernel - plain| "
        f"{worst}")
    for name, by_d in f16_rows.items():
        if name == "flash_attention":
            tol = dict(F16_TC_TOL, atol_needed=f16_atol)
        elif name == "flash_attention_bwd":
            tol = dict(F16_BWD_TC_TOL, tc=f16_seen["tc"])
        else:
            tol = dict(F16_BWD_TC_TOL, tc=f16_seen["split"]["tc"])
        rows[name]["fp16"] = dict(by_d, launches_tc_phase25=f16_tc[name],
                                  tol=tol)
    for r in rows.values():
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}) at {r['shape']}")
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows


# ---------------------------------------------------------------------------
# phase 26: gradients of the 2.7B, kernels vs the materialised scores
# ---------------------------------------------------------------------------

def gpt_2p7b_args():
    """``apex_tpu_torch.examples.gpt_train``'s arguments for the 2.7B
    step: the example's defaults (batch 8, lr 3e-4, tree Adam, full
    remat) at ``--preset 2p7b --steps 5``."""
    from apex_tpu_torch.examples import gpt_train

    return gpt_train.parse_args(["--preset", "2p7b", "--steps", "5"])


def phase_2p7b_grads():
    """Phase 26: one loss gradient of the 2.7B at batch 1, seq 1024, on
    weights from seed 0, through the head-major kernels (bf16), the "xla"
    attention in bf16 and the "xla" attention in fp32 (the reference),
    held by :func:`_hold_grads` (the kernel path within 3x the bf16 "xla"
    path's error)."""
    import dataclasses

    from apex_tpu_torch.examples import gpt_train
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import gpt

    cfg = gpt_train.config(gpt_2p7b_args())
    params = gpt.init(cfg, torch.Generator("cuda").manual_seed(0))
    tok = torch.as_tensor(np.random.default_rng(26).integers(
        0, cfg.vocab_size, (1, cfg.seq_len)), device="cuda")
    tgt = torch.roll(tok, -1, 1)
    paths = {"kernel": dataclasses.replace(cfg, attn_impl="flash"),
             "xla": dataclasses.replace(cfg, attn_impl="xla"),
             "fp32": dataclasses.replace(cfg, attn_impl="xla",
                                         compute_dtype=torch.float32)}
    torch.backends.cuda.matmul.allow_tf32 = False
    got = {}
    for name, c in paths.items():
        reset_launch_counts()
        got[name] = _loss_grads(lambda p, c=c: gpt.loss(c, p, tok, tgt),
                                params)
        if name == "kernel":
            counts = launch_counts()
            check(counts["flash_attention"] == 2 * cfg.num_layers
                  and counts["flash_attention_tc"] == 2 * cfg.num_layers
                  and counts["flash_attention_bsh"] == 0,
                  f"2.7B grads: head-major forward launched "
                  f"{counts['flash_attention']} times (expected "
                  f"{2 * cfg.num_layers}: the remat replay), lane-packed "
                  f"{counts['flash_attention_bsh']}")
    del params
    out = _hold_grads("grads at 2.7B, batch 1", got)
    del got
    gc.collect()
    torch.cuda.empty_cache()
    reset_launch_counts()
    return out


# ---------------------------------------------------------------------------
# phase 27: the 2.7B step; phase 28: where its time goes
# ---------------------------------------------------------------------------

#: fused vs split head-major backward in the 2.7B step, both on the
#: tensor cores: the same gradients up to dQ's summation order (atomics
#: in the fused kernel, one fixed order in the split one), so step 0's
#: losses are equal (the forward has not seen a backward yet) and later
#: ones carry bf16 training's rounding forward, as the GPT step's two
#: optimizer layouts do (LAYOUT_LOSS_BAND)
SPLIT_LOSS_BAND = LAYOUT_LOSS_BAND
#: the head-major vs lane-packed 355M step: other kernels for the same
#: attention, so every loss carries their bf16 rounding
BHSD_LOSS_BAND = LAYOUT_LOSS_BAND


def _run_2p7b(trainer, steps: int, what: str, *, profile: bool = False):
    """``steps`` steps of the example's ``train`` from seed 0's state,
    launch counts zeroed just before and read just after, peak memory from
    a reset; with ``profile`` also phase 28's profiler window over 2 more
    steps. Returns the metrics."""
    from apex_tpu_torch.examples import gpt_train
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    # the initial state goes straight in: a reference kept here would pin
    # its 10.6 GB of params through every step
    res = gpt_train.train(
        trainer, steps, trainer.init_fn(
            torch.Generator("cuda").manual_seed(0)), log=None)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    state = res.pop("state")
    tokens = trainer.tokens.numel()
    metrics = dict(
        run=what, losses=res["losses"],
        step_ms=[t * 1e3 for t in res["step_s"]],
        median_step_ms=res["median_step_s"] * 1e3,
        train_tokens_per_sec=res["tokens_per_sec"],
        init_and_first_step_ms=(wall - sum(res["step_s"])) * 1e3,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        launches={k_: v_ for k_, v_ in counts.items() if v_},
        launches_per_step={k_: v_ / steps for k_, v_ in counts.items()
                           if v_}, tokens_per_step=tokens)
    log(f"2.7B {what}: " + json.dumps(metrics))
    check(all(np.isfinite(res["losses"])), f"2.7B {what}: non-finite loss")
    prof = None
    if profile:
        prof = phase_train_profile(f"2.7B {what}", state, trainer.step_fn,
                                   (trainer.tokens, trainer.targets))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, counts, prof


def _log_2p7b_profile(what: str, prof) -> None:
    """The head-major flash kernels' share of a 2.7B step's device time,
    from phase 28's window (the backward's category holds the fused
    kernel or the split pair)."""
    if prof is None:
        return
    busy = prof["device_busy_ms"] / prof["window_steps"]
    cats = prof["device_ms_per_step_by_category"]
    fwd = cats.get("flash_fwd_tc", 0.0) + cats.get("flash_fwd_hm", 0.0)
    hm = fwd + cats.get("flash_bwd_tc", 0.0) + cats.get("flash_bwd_hm", 0.0)
    log(f"2.7B {what} profile: head-major kernels {hm:.2f} of {busy:.2f} "
        f"device ms a step (share {hm / busy:.4f}; the forward {fwd:.2f}), "
        f"idle share {prof['device_idle_share']:.4f}")


def phase_2p7b_train():
    """Phase 27 (and 28): ``apex_tpu_torch.examples.gpt_train --preset
    2p7b``'s step — one warm-up and 5 timed steps (the example's
    ``--steps 5``) with the fused backward, every loss finite and the
    last below the first, and per step the head-major forward on every
    layer twice (full remat replays it), 32 fused backwards and no
    lane-packed launch; phase 28's profiler window over 2 more steps;
    then 3 steps under ``APEX_TPU_FLASH_BWD=split`` (32 dQ and 32 dK/dV
    launches a step, all on the tensor cores, losses within
    SPLIT_LOSS_BAND of the fused run's, the median step logged beside the
    fused run's) and a profiler window over 2 more. Returns (fused
    metrics, split metrics)."""
    import os

    from apex_tpu_torch.examples import gpt_train

    args = gpt_2p7b_args()
    trainer = gpt_train.build(args)
    L = trainer.cfg.num_layers
    steps = 1 + args.steps
    fused, counts, prof = _run_2p7b(trainer, steps, "fused", profile=True)
    want = {"flash_attention": 2 * L * steps,
            "flash_attention_tc": 2 * L * steps,
            "flash_attention_bwd": L * steps,
            "flash_attention_bwd_tc": L * steps,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
            "flash_attention_bwd_dq_tc": 0, "flash_attention_bwd_dkdv_tc": 0,
            "flash_attention_bsh": 0, "flash_attention_bsh_bwd": 0}
    for name, n in want.items():
        check(counts[name] == n, f"2.7B fused: {name} launched "
              f"{counts[name]} times, expected {n}")
    losses = fused["losses"]
    check(abs(losses[0] - math.log(trainer.cfg.vocab_size)) < 1.0,
          f"2.7B: first loss {losses[0]} is not near ln(vocab)")
    check(losses[-1] < losses[0],
          f"2.7B: the loss did not fall ({losses[0]} -> {losses[-1]})")
    _log_2p7b_profile("fused", prof)

    os.environ["APEX_TPU_FLASH_BWD"] = "split"
    try:
        split, counts, prof = _run_2p7b(trainer, 3, "split", profile=True)
    finally:
        del os.environ["APEX_TPU_FLASH_BWD"]
    _log_2p7b_profile("split", prof)
    want = {"flash_attention": 2 * L * 3, "flash_attention_tc": 2 * L * 3,
            "flash_attention_bwd": 0, "flash_attention_bwd_tc": 0,
            "flash_attention_bwd_dq": L * 3,
            "flash_attention_bwd_dkdv": L * 3,
            "flash_attention_bwd_dq_tc": L * 3,
            "flash_attention_bwd_dkdv_tc": L * 3, "flash_attention_bsh": 0,
            "flash_attention_bsh_bwd": 0}
    for name, n in want.items():
        check(counts[name] == n, f"2.7B split: {name} launched "
              f"{counts[name]} times, expected {n}")
    gap = max(abs(a - b_) for a, b_ in zip(split["losses"], losses))
    log(f"2.7B: split vs fused max|loss diff| over 3 steps {gap:.3e} (band "
        f"{SPLIT_LOSS_BAND}); step 0 {split['losses'][0]} vs {losses[0]}; "
        f"median step {split['median_step_ms']:.2f} ms split, "
        f"{fused['median_step_ms']:.2f} ms fused (ratio "
        f"{split['median_step_ms'] / fused['median_step_ms']:.4f})")
    check(split["losses"][0] == losses[0],
          "2.7B: step 0's loss differs between the fused and split runs")
    check(gap <= SPLIT_LOSS_BAND, f"2.7B: split and fused losses differ by "
          f"{gap}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return fused, split


# ---------------------------------------------------------------------------
# phase 34: serve Megatron-GPT 2.7B (32 heads of 80) through Engine and
# Scheduler
# ---------------------------------------------------------------------------

#: the decode kernels each side of phase 34 runs once a layer every
#: decode step: the fused write + read (compute-dtype caches), or the
#: quantized column write and read
SERVE_2P7B_KERNELS = {
    "contiguous": ("decode_attention_write",),
    "paged": ("paged_attention_write",),
    "int8": ("decode_write_column_quant", "decode_attention_quant"),
    "paged int8": ("paged_write_column_quant", "paged_attention_quant"),
    "spec": ("decode_attention_write",),
}


def serve_2p7b_config(**over):
    """The 2.7B (``apex_tpu_torch.examples.gpt_train``'s ``2p7b`` preset:
    vocab 50304, hidden 2560, 32 layers of 32 heads of 80, seq 1024) in
    its decode form, as :func:`model_config` is the 355M's: bf16 weights
    (5.3 GB) and compute, flash prefill (the head-major kernels)."""
    from apex_tpu_torch.examples import gpt_train
    from apex_tpu_torch.models import gpt

    return gpt.GPTConfig(**{**gpt_train.PRESETS["2p7b"], **dict(
        remat=False, compute_dtype=torch.bfloat16,
        param_dtype=torch.bfloat16, attn_impl="flash", ln_impl="xla"),
        **over})


def phase_2p7b_serve():
    """Phase 34: the 2.7B on weights from seed 0. Phase 4's cross-check
    at its width (bf16 and fp16 through the kernels against the "xla"
    forms and fp32) and phase 20's quantized logits (fp32: int8 within
    KV_TOL of the compute cache, fp8 within twice its own "xla" read's
    error, see :func:`phase_quant_logits`). Then bench's 32-request trace
    through ``Scheduler(Engine(...))`` (8 slots, prompts <= 64, horizon
    192, 64 tokens each) five ways: contiguous bf16, paged (pages of 8),
    int8, paged int8 and speculative (``spec_k=3``, chunks of 4, under
    the scheduler's gate). Launch counts zeroed just before each run and
    read just after: per decode step every layer runs the side's fused
    write + read (compute-dtype caches) or its quantized column write and
    read, and no other single-column decode kernel (SERVE_2P7B_KERNELS),
    every prefill the head-major
    flash forward on the tensor cores, and every verify wave the verify
    launch (the multi-column write inside the T-row read). Streams: contiguous within phase 4's band of a
    teacher-forced forward; paged identical to contiguous, paged int8 to
    int8; int8 and spec identical to contiguous or first diverging where
    the reference's top-2 gap is within the band (int8: plus twice its
    logit error), as phase 20 holds them. Decode tokens/s, TTFT and peak
    memory per side, and phase 6's profiler window over the contiguous
    and the int8 engine (phase 35: each runs only its own instantiations
    of the split read). Returns (metrics, launch counts per side)."""
    import dataclasses

    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.serving import EngineConfig

    cfg = serve_2p7b_config()
    params = gpt.init(cfg, torch.Generator("cuda").manual_seed(0))
    t = time.perf_counter()
    band = 3 * phase_model(cfg, params, fp16=True)
    quant_err = phase_quant_logits(cfg, params, beside_xla=("fp8",))
    log(f"2.7B model and quantized logits {time.perf_counter() - t:.1f}s")
    L = cfg.num_layers
    int8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    ecfg = EngineConfig(slots=SLOTS, max_prompt_len=64, max_seq_len=HORIZON)
    paged = dataclasses.replace(ecfg, page_size=PAGE)
    sides = {"contiguous": (cfg, ecfg), "paged": (cfg, paged),
             "int8": (int8, ecfg), "paged int8": (int8, paged),
             "spec": (cfg, dataclasses.replace(ecfg, decode_chunk=4,
                                               spec_k=SPEC_K))}
    reqs = bench_trace(cfg.vocab_size)
    streams, comps, out, launches = {}, {}, {}, {}
    for name, (c, e) in sides.items():
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        engine, sched, wall, counts = serve_timed(c, params, e,
                                                  bench_trace(cfg.vocab_size))
        peak = torch.cuda.max_memory_allocated()
        s = sched.summary()
        what = f"2.7B {name}"
        check(len(sched.completions) == len(reqs),
              f"{what}: not every request completed")
        for r in reqs:
            comp = sched.completions[r.request_id]
            check(len(comp.tokens) == r.max_tokens
                  or comp.finish_reason == "eos",
                  f"{what}: {r.request_id} emitted {len(comp.tokens)} tokens")
            check(all(0 <= x < cfg.vocab_size for x in comp.tokens),
                  f"{what}: {r.request_id} emitted a token outside the vocab")
        on = SERVE_2P7B_KERNELS[name]
        steps = engine.decode_steps_taken
        check_decode_step_kernels(what, counts, on, steps, L,
                                  allow_no_steps=name == "spec")
        check(counts["flash_attention"] == L * engine.admit_groups > 0
              and counts["flash_attention_bsh"] == 0,
              f"{what}: head-major prefill launched "
              f"{counts['flash_attention']} times, expected {L} x "
              f"{engine.admit_groups} groups (lane-packed "
              f"{counts['flash_attention_bsh']})")
        check_tc(what, counts, "flash_attention")
        row = dict(wall_s=wall, peak_memory_bytes=peak, decode_steps=steps,
                   admit_groups=engine.admit_groups,
                   launches={k: counts[k] for k in on},
                   **{k: s[k] for k in (
                       "tokens_per_sec", "decode_tokens_per_sec",
                       "ttft_mean_ms", "ttft_p99_ms", "tokens_emitted")})
        if name == "spec":
            waves = engine.spec_waves_taken
            check(counts["decode_verify_attention"] == L * waves > 0
                  and counts["cache_write_columns"] == 0,
                  f"{what}: decode_verify_attention launched "
                  f"{counts['decode_verify_attention']} times, expected {L} "
                  f"x {waves} verify waves (cache_write_columns "
                  f"{counts['cache_write_columns']})")
            row.update(verify_waves=waves, **{k: s[k] for k in (
                "spec_tokens_per_wave", "spec_accept_rate",
                "spec_gate_state")})
            for k in ("decode_verify_attention", "cache_write_columns"):
                row["launches"][k] = counts[k]
        if name in ("contiguous", "int8"):
            prof = phase_profile(c, engine)
            row["device_idle_share"] = (prof or {}).get("device_idle_share")
            if prof is not None:
                row["decode_reads"] = prof["decode_reads"]
                want = "quantized" if name == "int8" else "plain"
                other = "plain" if name == "int8" else "quantized"
                check(prof["decode_reads"][want]["calls"] > 0
                      and prof["decode_reads"][other]["calls"] == 0,
                      f"{what}: the profile's decode reads "
                      f"{prof['decode_reads']}, expected only {want} "
                      f"instantiations of the split read")
        log(f"{what}: " + json.dumps(row))
        out[name], launches[name] = row, counts
        streams[name] = {r: c_.tokens for r, c_ in sched.completions.items()}
        comps[name] = sched.completions
        del engine, sched

    held = hold_streams(cfg, params, reqs, comps["contiguous"])
    check(max(held) <= band, f"2.7B contiguous: streams off the reference "
          f"by {held} (band {band})")
    for name, base in (("paged", "contiguous"), ("paged int8", "int8")):
        drift = [r for r in streams[base]
                 if streams[name].get(r) != streams[base][r]]
        check(not drift, f"2.7B {name}: streams differ from {base} for "
              f"{drift}")
    out["streams"] = dict(contiguous_vs_reference=held, band=band)
    for name, lim in (("int8", band + 2 * quant_err["int8"]),
                      ("spec", band)):
        gaps = _drift_gaps(cfg, params, reqs, streams[name],
                           streams["contiguous"])
        h = hold_streams(cfg, params, reqs, comps[name])
        out["streams"][name] = dict(
            drift=len(gaps), first_divergence_gaps=gaps, band=lim,
            max_logprob_err=h[0], greedy_gap=h[1])
        check(all(g <= lim for _, _, g in gaps),
              f"2.7B {name}: a stream leaves the contiguous one at a gap "
              f"above {lim}: {gaps}")
        check(max(h) <= lim, f"2.7B {name}: streams off the reference by "
              f"{h} (band {lim})")
    log("2.7B streams: paged == contiguous and paged int8 == int8 (32 "
        "each); " + json.dumps(out["streams"]))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out, launches


def phase_bhsd_355m(tcfg, tok, tgt, tree):
    """Phase 27's 355M comparison: phase 9's tree-layout step with
    ``attn_layout="bhsd"`` (the head-major kernels), one warm-up and 3
    timed steps, against phase 9's lane-packed run (``tree``) in the same
    call: per step 24 head-major forwards (the policy saves their output)
    and 24 fused backwards, no lane-packed launch, losses within
    BHSD_LOSS_BAND of the lane-packed run's. Returns the metrics."""
    import dataclasses

    from apex_tpu_torch.amp import ScalerConfig
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import make_train_step
    from apex_tpu_torch.optimizers import fused_adam

    cfg = dataclasses.replace(tcfg, attn_layout="bhsd")
    init_fn, step_fn = make_train_step(cfg, fused_adam(1e-4, layout="tree"),
                                       ScalerConfig(enabled=False))
    state = init_fn(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, m = step_fn(state, tok, tgt)
    losses = [float(m["loss"])]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        state, m = step_fn(state, tok, tgt)
        losses.append(float(m["loss"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    del state
    torch.cuda.empty_cache()
    L, n = cfg.num_layers, 4
    metrics = dict(step_ms=wall / 3 * 1e3,
                   train_tokens_per_sec=3 * tok.numel() / wall,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   losses=losses, lane_packed_step_ms=tree["step_ms"],
                   ratio_to_lane_packed=(wall / 3 * 1e3) / tree["step_ms"])
    log("355M bhsd tree step: " + json.dumps(metrics))
    for name, want in (("flash_attention", L * n),
                       ("flash_attention_tc", L * n),
                       ("flash_attention_bwd", L * n),
                       ("flash_attention_bwd_tc", L * n),
                       ("flash_attention_bsh", 0),
                       ("flash_attention_bsh_bwd", 0)):
        check(counts[name] == want, f"355M bhsd: {name} launched "
              f"{counts[name]} times, expected {want}")
    gap = max(abs(a - b_) for a, b_ in zip(losses, tree["losses"]))
    check(gap <= BHSD_LOSS_BAND,
          f"355M bhsd: losses differ from the lane-packed run's by {gap}")
    log(f"355M: head-major / lane-packed step {metrics['step_ms']:.2f} / "
        f"{tree['step_ms']:.2f} ms = {metrics['ratio_to_lane_packed']:.4f}; "
        f"max|loss diff| over {n} steps {gap:.3e} (band {BHSD_LOSS_BAND})")
    reset_launch_counts()
    return metrics


# ---------------------------------------------------------------------------
# phase 29: the L3 flat kernels (scale, axpby, adagrad) vs plain
# ---------------------------------------------------------------------------

#: the L3 loop's static loss scale (apex's unscale_with_stashed: a = 1/S)
L3_SCALE = 2.0 ** 12


def _flat_row(name, line, errs, step_k, plain_k, n_bytes, n_flops, lib_ms,
              lib_name, shape):
    """One kernels-line row of a flat sweep, timed as in phase 3."""
    b, by = bound(n_bytes, n_flops, FP32_FLOPS_PER_S)
    row = dict(
        name=name, route="cuda", source="apex_tpu_torch/csrc/flat_ops.cu",
        replaces=f"apex_tpu/kernels/flat_ops.py:{line}",
        max_abs_err=max(errs), ms=time_ms(step_k, **TRAIN_TIMING),
        eager_ms=eager_ms(step_k, **TRAIN_TIMING),
        plain_ms=time_ms(plain_k, **TRAIN_TIMING), bound_ms=b, bound_by=by,
        library_ms=lib_ms, library=lib_name, shape=shape)
    log(f"kernel {name}: {row['ms']:.4f} ms (eager {row['eager_ms']:.4f} "
        f"ms), plain {row['plain_ms']:.4f} ms, library "
        f"{row['library_ms']:.4f} ms ({lib_name}), bound "
        f"{row['bound_ms']:.5f} ms ({by}) at {shape}")
    return row


def phase_l3_flat_kernels(tcfg):
    """Phase 29: ``scale_flat``, ``axpby_flat`` and ``adagrad_flat``
    against their plain versions on the 355M's padded fp32 group (and
    small bf16 and fp16 groups): scale and axpby bit-equal, with the
    found-inf flag raised by an inf input (scale) and an fp32 overflow
    (axpby) and not by an fp16 narrowing overflow; adagrad within
    ADAM_TOL, its delta mode and a skipped sweep; timed beside their
    library calls. Returns the three rows."""
    from apex_tpu_torch.kernels import (
        adagrad_flat,
        adagrad_flat_plain,
        axpby_flat,
        axpby_flat_plain,
        reset_launch_counts,
        scale_flat,
        scale_flat_plain,
    )
    from apex_tpu_torch.kernels.flat_ops import _widen, adagrad_scalars
    from apex_tpu_torch.multi_tensor import pad_to

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    n = pad_to(tcfg.param_count())
    small = 4 * 65536
    rand = lambda m, s=1.0: torch.randn(m, generator=g, device=dev) * s
    rows, errs = {}, {"scale_flat": [], "axpby_flat": [], "adagrad_flat": []}
    one = lambda x: torch.full((), x, device=dev)

    # -- scale and axpby: bit-equal to plain, the flag's two rules
    groups = [rand(n, 3.0), rand(small, 3.0).bfloat16(),
              rand(small, 3.0).half()]
    s = 1.0 / L3_SCALE
    ko, kf = scale_flat(groups, s)
    po, pf = scale_flat_plain([_widen(b) for b in groups], one(s))
    po = [p.to(b.dtype) for p, b in zip(po, groups)]
    torch.cuda.synchronize()
    errs["scale_flat"] += [max_err(k, p) for k, p in zip(ko, po)]
    check(all(torch.equal(k, p) for k, p in zip(ko, po)),
          f"scale_flat: not bit-equal to plain (errs {errs['scale_flat']})")
    check(not bool(kf) and not bool(pf), "scale_flat: flag set")
    x16 = groups[2].clone()
    x16[5] = float("inf")
    check(bool(scale_flat([groups[0], x16], s)[1]),
          "scale_flat: an inf input did not raise the flag")
    o16, f16 = scale_flat([groups[2]], 2.0 ** 15)
    check(bool(o16[0].isinf().any()) and not bool(f16),
          "scale_flat: an fp16 narrowing overflow must give inf, no flag")
    ys = [rand(n, 2.0), rand(small, 2.0).bfloat16(), rand(small).half()]
    for out_dtype in (None, torch.float32):
        ko, kf = axpby_flat(s, groups, 1.0, ys, out_dtype=out_dtype)
        want = [out_dtype or b.dtype for b in groups]
        po, pf = axpby_flat_plain(
            torch.stack([one(s), one(1.0)]), [_widen(b) for b in groups],
            [_widen(y) for y in ys],
            [torch.float32 if w == torch.float16 else w for w in want])
        po = [p.to(w) for p, w in zip(po, want)]
        torch.cuda.synchronize()
        errs["axpby_flat"] += [max_err(k, p) for k, p in zip(ko, po)]
        check(all(torch.equal(k, p) for k, p in zip(ko, po)),
              f"axpby_flat out_dtype={out_dtype}: not bit-equal to plain "
              f"(errs {errs['axpby_flat']})")
        check(not bool(kf) and not bool(pf), "axpby_flat: flag set")
    big = groups[0].clone()
    big[7] = 3e38
    check(bool(axpby_flat(4.0, [big], 1.0, [ys[0]])[1]),
          "axpby_flat: an fp32 overflow did not raise the flag")
    o16, f16 = axpby_flat(2.0 ** 15, [groups[2]], 1.0, [ys[2]])
    check(bool(o16[0].isinf().any()) and not bool(f16),
          "axpby_flat: an fp16 narrowing overflow must give inf, no flag")
    # axpby at a size no tile divides (and n % 8 == 4: a bf16 operand's
    # last 16-byte vector is cut to 8 bytes) in each dtype combination,
    # and its flag at the first and the last element
    odd = 4 * 65537
    bf, f32 = torch.bfloat16, torch.float32
    for xd in (f32, bf):
        for yd in (f32, bf):
            for od in (f32, bf):
                xo, yo = rand(odd, 3.0).to(xd), rand(odd, 2.0).to(yd)
                ko, kf = axpby_flat(s, [xo], 1.0, [yo], out_dtype=od)
                po, pf = axpby_flat_plain(torch.stack([one(s), one(1.0)]),
                                          [xo], [yo], [od])
                torch.cuda.synchronize()
                what = f"axpby_flat n={odd} x {xd} y {yd} out {od}"
                errs["axpby_flat"].append(max_err(ko[0], po[0]))
                check(torch.equal(ko[0], po[0]),
                      f"{what}: not bit-equal to plain (err "
                      f"{max_err(ko[0], po[0])})")
                check(not bool(kf) and not bool(pf), f"{what}: flag set")
                for at in (0, odd - 1):
                    xb = xo.clone()
                    xb[at] = 3e38  # bf16 holds it too; 4x it is inf
                    check(bool(axpby_flat(4.0, [xb], 1.0, [yo],
                                          out_dtype=od)[1]),
                          f"{what}: an fp32 overflow at element {at} did "
                          f"not raise the flag")
    for at in (0, n - 1):
        big = groups[0].clone()
        big[at] = 3e38
        check(bool(axpby_flat(4.0, [big], 1.0, [ys[0]])[1]),
              f"axpby_flat n={n}: an fp32 overflow at element {at} did not "
              f"raise the flag")
    log(f"scale_flat / axpby_flat: bit-equal to plain on the 355M fp32 group "
        f"and bf16/fp16 groups, axpby in its 8 x/y/out dtypes at n={odd}; "
        f"flags: inf input (scale), fp32 overflow (axpby, also at the first "
        f"and last element) raise it, fp16 narrowing overflow does not")
    del big, x16, o16, xo, yo, xb

    x, y = groups[0], ys[0]
    found = torch.zeros(1, device=dev)
    inv = one(0.5)
    lib_x = x.clone()
    rows["scale_flat"] = _flat_row(
        "scale_flat", 94, errs["scale_flat"], lambda: scale_flat([x], s),
        lambda: scale_flat_plain([x], one(s)), 8 * n, n,
        time_ms(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
            [lib_x], found, inv), **TRAIN_TIMING),
        "torch._amp_foreach_non_finite_check_and_unscale_ (in place)",
        f"one fp32 group of n={n} (355M params, padded)")
    ab = torch.stack([one(s), one(1.0)])
    rows["axpby_flat"] = _flat_row(
        "axpby_flat", 145, errs["axpby_flat"],
        lambda: axpby_flat(s, [x], 1.0, [y]),
        lambda: axpby_flat_plain(ab, [x], [y], [torch.float32]), 12 * n,
        3 * n, time_ms(lambda: torch.add(y, x, alpha=s), **TRAIN_TIMING),
        "torch.add(y, x, alpha=a)", f"fp32 x, y of n={n}")
    rows["axpby_flat"]["device_ops_per_call"] = {
        k: n for k, (n, _) in device_ops(
            lambda: axpby_flat(s, [x], 1.0, [y])).items()}
    log(f"axpby_flat with numbers a, b: one call ran "
        f"{rows['axpby_flat']['device_ops_per_call']}")
    del groups, ys, lib_x, found

    # -- adagrad: small bf16 group (delta mode, skip), then the 355M group
    hp = dict(lr=1e-2, eps=1e-10, weight_decay=1e-4, grad_scale=0.5)
    scalars = adagrad_scalars(*hp.values(), dev)

    def ada_both(p, gr, h, **flags):
        pk, hk, pp, hp_ = p.clone(), h.clone(), p.clone(), h.clone()
        ok, _ = adagrad_flat([pk], [gr], [hk], **hp, **flags)
        op, _ = adagrad_flat_plain([pp], [gr], [hp_], scalars, **flags)
        torch.cuda.synchronize()
        return (ok[0], hk), (op[0], hp_), pk

    for flags in ({}, dict(out_is_delta=True)):
        p = rand(small, 0.05).bfloat16()
        gr, h = rand(small, 1e-2), rand(small, 1e-3).abs()
        (ok, hk), (op, hp_), pk = ada_both(p, gr, h, **flags)
        # bf16 params: both sides round the same fp32 result once, and
        # one step moves p by several bf16 ulps; fp32 deltas: ADAM_TOL
        pk_ok = close(ok, op, ADAM_TOL) if flags else ulp_close(ok, op)
        check(pk_ok and close(hk, hp_, ADAM_TOL),
              f"adagrad_flat bf16 {flags}: errs {max_err(ok, op)}, "
              f"{max_err(hk, hp_)}")
        if flags:
            check(torch.equal(pk, p), "adagrad_flat delta mode changed p")
    before = (pk.clone(), hk.clone())
    adagrad_flat([pk], [gr], [hk], **hp,
                 skip=torch.ones((), dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    check(torch.equal(pk, before[0]) and torch.equal(hk, before[1]),
          "adagrad_flat: skip=True changed a buffer")
    p, gr, h = rand(n, 0.02), rand(n, 1e-3), rand(n, 1e-6).abs()
    (ok, hk), (op, hp_), _ = ada_both(p, gr, h)
    e = [max_err(ok, op), max_err(hk, hp_)]
    check(close(ok, op, ADAM_TOL) and close(hk, hp_, ADAM_TOL),
          f"adagrad_flat n={n}: errs {e}")
    errs["adagrad_flat"] += e
    # torch's Adagrad on one flat tensor from a zero sum: the same update
    pa, ha = p.clone(), torch.zeros_like(h)
    adagrad_flat([pa], [gr], [ha], lr=1e-2, eps=1e-10, weight_decay=0.0)
    w = torch.nn.Parameter(p.clone())
    w.grad = gr.clone()
    lib = torch.optim.Adagrad([w], lr=1e-2, eps=1e-10, foreach=True)
    lib.step()
    torch.cuda.synchronize()
    lib_err = max_err(pa, w.detach())
    check(close(pa, w.detach(), ADAM_TOL),
          f"adagrad_flat vs torch.optim.Adagrad: err {lib_err}")
    log(f"adagrad_flat n={n} fp32: max|p,h - plain|={e} (tol atol=1e-6 "
        f"rtol=1e-5); vs torch.optim.Adagrad(foreach) {lib_err:.3e}; bf16 "
        f"group, delta mode and skip ok")
    del op, hp_, pa, ha, pk
    rows["adagrad_flat"] = _flat_row(
        "adagrad_flat", 371, errs["adagrad_flat"],
        lambda: adagrad_flat([ok], [gr], [hk], **hp),
        lambda: adagrad_flat_plain([p], [gr], [h], scalars), 20 * n, 8 * n,
        eager_ms(lib.step, **TRAIN_TIMING), "torch.optim.Adagrad("
        "foreach=True).step", f"one fp32 group of n={n} (355M, padded)")
    del p, gr, h, ok, hk, w, lib
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows


# ---------------------------------------------------------------------------
# phase 30: the softmax kernels vs plain, and FusedScaleMaskSoftmax
# ---------------------------------------------------------------------------

#: the unfused scores of the GPT-2 355M step (batch 16, 16 heads, seq
#: 1024) and of BERT-large's (batch 32, 16 heads, seq 512)
SM_GPT = (16, 16, 1024, 1024)
SM_BERT = (32, 16, 512, 512)
#: BERT's padding mask masks keys 400 on, and every key of this many
#: batches (rows the fused path gives zeros and the unfused one 1/sk)
SM_BERT_MASKED = 3


@contextlib.contextmanager
def softmax_routes():
    """The routes ``softmax_fwd`` hands its C entry while the block runs,
    in order (``kernels/softmax.py:fwd_route`` wrapped by a recorder)."""
    from apex_tpu_torch.kernels import softmax as sm

    seen, real = [], sm.fwd_route

    def record(*args):
        seen.append(real(*args))
        return seen[-1]
    sm.fwd_route = record
    try:
        yield seen
    finally:
        sm.fwd_route = real


def softmax_on_route(x3, m, scale: float, causal: bool, route: int):
    """``csrc/softmax.cu``'s forward on ``route`` (1: the row in registers,
    0: the general kernel), launched directly on ``x3`` and the byte mask
    ``m`` (``[nb / ratio, sq, sk]``, 0 or 1, or None): ``(launch, y3)``.
    Its launches are not counted."""
    from apex_tpu_torch.kernels import _build

    nb, sq, sk = x3.shape
    y3 = torch.empty_like(x3)

    def launch():
        _build.check(_build.library().apex_tpu_torch_softmax_fwd(
            x3.data_ptr(), None if m is None else m.data_ptr(),
            y3.data_ptr(), nb * sq, sq, sk, 1 if m is None else
            nb // m.shape[0], float(scale), int(causal),
            _build.DTYPE_CODES[x3.dtype], route, _build.stream()),
            f"softmax_fwd route {route}")
    launch()
    return launch, y3


def phase_softmax():
    """Phase 30: the softmax forward and backward against their plain
    versions at the 355M's causal scores (bf16, scale 1/8) and BERT-large's
    padded ones (fp16 through the public API, a [32, 1, 1, 512] mask
    whose first batches mask every key), and at odd shapes (sk = 1000 and
    2500, the long-row path; sq != sk with a mask; the legacy [b, sq, sk]
    mask; fp32; causal bf16 at sk 8, 264 and 1000; the row-in-registers
    cap and one vector past it; a misaligned view), every forward on the
    route ``fwd_route`` must name; two launches bit-equal; timed beside
    ``torch.softmax`` and ``torch._softmax_backward_data`` on
    already-masked scores, the forward's two routes in turns at the 355M
    and BERT shapes (``general_ms``: route 0, the earlier design). Then
    the main path: ``FusedScaleMaskSoftmax`` forward and backward, fused
    and unfused, causal and padding, launch counts zeroed before and read
    after, both forwards on route 1. Returns (rows, counts)."""
    from apex_tpu_torch.kernels import (
        launch_counts,
        reset_launch_counts,
        scaled_masked_softmax,
        softmax_bwd,
        softmax_bwd_plain,
        softmax_fwd,
        softmax_fwd_plain,
    )
    from apex_tpu_torch.kernels import _build
    from apex_tpu_torch.kernels.softmax import _mask3
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(30)
    rand = lambda shape, dt: (torch.randn(shape, generator=g, device=dev)
                              * 2).to(dt)
    errs = {"softmax_fwd": [], "softmax_bwd": []}

    def both(x3, m3, scale, causal, what, route):
        with softmax_routes() as seen:
            yk = softmax_fwd(x3, m3, scale=scale, causal=causal)
        check(seen == [route], f"softmax_fwd {what}: routes {seen}, "
              f"expected [{route}]")
        yp = softmax_fwd_plain(x3, m3, scale, causal)
        dy = rand(x3.shape, x3.dtype)
        dk = softmax_bwd(yk, dy, scale=scale)
        dp = softmax_bwd_plain(yk, dy, scale)
        torch.cuda.synchronize()
        check(ulp_close(yk, yp), f"softmax_fwd {what}: err {max_err(yk, yp)}")
        check(close(dk, dp, FP32_TOL) and (
            dk.dtype == torch.float32 or ulp_close(dk, dp)),
            f"softmax_bwd {what}: err {max_err(dk, dp)}")
        check(bool(torch.isfinite(yk).all()), f"softmax {what}: non-finite")
        errs["softmax_fwd"].append(max_err(yk, yp))
        errs["softmax_bwd"].append(max_err(dk, dp))
        return yk, dy

    # odd shapes: sk = 1000 and 2500 (past the shared-memory row cache),
    # sq != sk with a ratio-tiled mask, the legacy mask, fp32; causal bf16
    # rows whose diagonal straddles a 16-byte vector at every offset (sk 8,
    # 264, 1000); the row-in-registers cap (route 1) and one vector past it
    # (route 0), each in bf16 and fp32
    cap = _build.SOFTMAX_ROWS_MAX_COLS
    bf, f32 = torch.bfloat16, torch.float32
    for shape, mshape, dt, causal, route in (
            ((2, 3, 7, 1000), (2, 1, 1, 1000), bf, False, 1),
            ((1, 2, 5, 2500), (1, 1, 5, 2500), f32, False, 0),
            ((2, 2, 5, 24), (2, 1, 5, 24), f32, False, 1),
            ((2, 4, 6, 6), None, bf, True, 0),
            ((3, 2, 17, 17), (3, 1, 1, 17), f32, True, 0),
            ((2, 2, 8, 8), None, bf, True, 1),
            ((2, 2, 264, 264), None, bf, True, 1),
            ((2, 2, 1000, 1000), (2, 1, 1, 1000), bf, True, 1),
            ((1, 2, cap, cap), None, bf, True, 1),
            ((1, 2, cap + 8, cap + 8), None, bf, True, 0),
            ((1, 2, 16, cap), (1, 1, 16, cap), f32, False, 1),
            ((1, 2, 16, cap + 4), (1, 1, 16, cap + 4), f32, False, 0)):
        x = rand(shape, dt)
        m = None
        if mshape is not None:
            m = torch.rand(mshape, generator=g, device=dev) < 0.3
            m[..., 0] = False
        both(x.reshape(-1, *shape[-2:]), None if m is None else
             _mask3(m, x), 0.5, causal, f"{shape} {dt}", route)
    x = rand((2, 3, 8, 40), torch.bfloat16)
    legacy = torch.rand((2, 8, 40), generator=g, device=dev) < 0.3
    both(x.reshape(-1, 8, 40), _mask3(legacy, x), 1.0, False, "legacy mask",
         1)
    # a view one element off its storage's 16-byte boundary: route 0
    flat = rand((4 * 64 * 64 + 1,), bf)
    both(flat[1:].view(4, 64, 64), None, 0.5, True, "misaligned view", 0)
    log(f"softmax odd shapes ok, each on its route (max errs fwd "
        f"{max(errs['softmax_fwd']):.3e}, bwd {max(errs['softmax_bwd']):.3e})")

    # the 355M's causal scores, bf16, scale 1/8: route 1, two launches
    # bit-equal
    nb, sq, sk = SM_GPT[0] * SM_GPT[1], SM_GPT[2], SM_GPT[3]
    x3 = rand((nb, sq, sk), torch.bfloat16)
    y3, dy3 = both(x3, None, 0.125, True, "355M causal bf16", 1)
    again = softmax_fwd(x3, None, scale=0.125, causal=True)
    torch.cuda.synchronize()
    check(torch.equal(again, y3),
          "softmax_fwd 355M: two launches differ in their bits")
    del again
    rows_gpt, _ = softmax_on_route(x3, None, 0.125, True, 1)
    general_gpt, y_general = softmax_on_route(x3, None, 0.125, True, 0)
    torch.cuda.synchronize()
    check(ulp_close(y_general, y3),
          f"softmax_fwd 355M: route 0 vs route 1 err {max_err(y_general, y3)}")
    del y_general
    tril = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril()
    xm = (x3.float() * 0.125).masked_fill(~tril, float("-inf")).to(
        torch.bfloat16)
    n_el = x3.numel()
    # causal: only the lower triangle of x is read (the kernel predicates
    # the loads above the diagonal off) and exponentiated; all of y is
    # written
    tri = nb * sq * (sq + 1) // 2
    fb, fby = bound(2 * tri + 2 * n_el, 5 * tri, FP32_FLOPS_PER_S)
    bb, bby = bound(6 * n_el, 4 * n_el, FP32_FLOPS_PER_S)
    shape = f"[{SM_GPT[0]}, {SM_GPT[1]}, {sq}, {sk}] bf16, causal, scale 1/8"
    rows = {
        "softmax_fwd": dict(
            name="softmax_fwd", route="cuda",
            source="apex_tpu_torch/csrc/softmax.cu",
            replaces="apex_tpu/kernels/softmax.py:92",
            ms=time_ms(lambda: softmax_fwd(x3, None, scale=0.125,
                                           causal=True), **TRAIN_TIMING),
            eager_ms=eager_ms(lambda: softmax_fwd(
                x3, None, scale=0.125, causal=True), **TRAIN_TIMING),
            plain_ms=time_ms(lambda: softmax_fwd_plain(x3, None, 0.125, True),
                             **TRAIN_TIMING),
            bound_ms=fb, bound_by=fby,
            library_ms=time_ms(lambda: torch.softmax(xm, -1),
                               **TRAIN_TIMING),
            library="torch.softmax on already scaled and masked scores",
            shape=shape),
        "softmax_bwd": dict(
            name="softmax_bwd", route="cuda",
            source="apex_tpu_torch/csrc/softmax.cu",
            replaces="apex_tpu/kernels/softmax.py:115",
            ms=time_ms(lambda: softmax_bwd(y3, dy3, scale=0.125),
                       **TRAIN_TIMING),
            eager_ms=eager_ms(lambda: softmax_bwd(y3, dy3, scale=0.125),
                              **TRAIN_TIMING),
            plain_ms=time_ms(lambda: softmax_bwd_plain(y3, dy3, 0.125),
                             **TRAIN_TIMING),
            bound_ms=bb, bound_by=bby,
            library_ms=time_ms(lambda: torch._softmax_backward_data(
                dy3, y3, -1, y3.dtype), **TRAIN_TIMING),
            library="torch._softmax_backward_data (no scale)",
            shape=shape)}
    del x3, y3, dy3, xm

    # the earlier design (route 0) and route 1 launched directly, in turns
    # (1, 0, 0, 1), at the same shape in the same call
    turns = {1: [], 0: []}
    for route in (1, 0, 0, 1):
        turns[route].append(time_ms(rows_gpt if route else general_gpt,
                                    **TRAIN_TIMING))
    rows["softmax_fwd"].update(rows_ms=min(turns[1]),
                               general_ms=min(turns[0]))
    del rows_gpt, general_gpt

    # BERT-large's padded scores in fp16 through the public API (widened to
    # the fp32 kernels, route 1), the first batches with every key masked
    xb = rand(SM_BERT, torch.float16)
    pad = torch.zeros((SM_BERT[0], 1, 1, SM_BERT[3]), dtype=torch.bool,
                      device=dev)
    pad[:, :, :, 400:] = True
    pad[:SM_BERT_MASKED] = True
    with softmax_routes() as seen:
        yk = scaled_masked_softmax(xb, pad, scale=0.125)
    check(seen == [1], f"softmax BERT fp16: routes {seen}, expected [1]")
    xb3 = xb.reshape(-1, *SM_BERT[2:]).float()
    mb = _mask3(pad, xb)
    yp = softmax_fwd_plain(xb3, mb, 0.125, False).to(
        torch.float16).reshape(SM_BERT)
    torch.cuda.synchronize()
    check(ulp_close(yk, yp), f"softmax BERT fp16: err {max_err(yk, yp)}")
    check(not bool(yk[:SM_BERT_MASKED].any()),
          "softmax BERT: a fully masked row is not all zeros")
    errs["softmax_fwd"].append(max_err(yk, yp))
    # both routes on the kernel's own operands (fp32 scores, the byte mask
    # tiled over 16 heads), held and timed in turns beside torch.softmax
    mbytes = (mb != 0).contiguous()
    rows_bert, y_rows = softmax_on_route(xb3, mbytes, 0.125, False, 1)
    general_bert, y_general = softmax_on_route(xb3, mbytes, 0.125, False, 0)
    yp32 = softmax_fwd_plain(xb3, mb, 0.125, False)
    torch.cuda.synchronize()
    check(ulp_close(y_rows, yp32) and ulp_close(y_general, yp32),
          f"softmax BERT fp32: routes 1 / 0 err {max_err(y_rows, yp32)} / "
          f"{max_err(y_general, yp32)}")
    errs["softmax_fwd"].append(max_err(y_rows, yp32))
    xbm = (xb3 * 0.125).masked_fill(
        mbytes.repeat_interleave(SM_BERT[1], dim=0).bool(), float("-inf"))
    turns = {1: [], 0: []}
    for route in (1, 0, 0, 1):
        turns[route].append(time_ms(rows_bert if route else general_bert,
                                    **TRAIN_TIMING))
    n_b = xb3.numel()
    bb_, bby_ = bound(8 * n_b + mbytes.numel(), 5 * n_b, FP32_FLOPS_PER_S)
    rows["softmax_fwd"]["bert"] = dict(
        ms=min(turns[1]), general_ms=min(turns[0]),
        library_ms=time_ms(lambda: torch.softmax(xbm, -1), **TRAIN_TIMING),
        bound_ms=bb_, bound_by=bby_,
        shape=f"{list(SM_BERT)} fp16 widened to fp32, a [32, 1, 1, 512] "
              f"padding mask (ratio 16), scale 1/8")
    log(f"softmax_fwd routes, in turns (min of 2 each): 355M causal bf16 "
        f"route 1 {rows['softmax_fwd']['rows_ms']:.4f} / route 0 "
        f"{rows['softmax_fwd']['general_ms']:.4f} ms; BERT fp32 masked "
        f"route 1 {rows['softmax_fwd']['bert']['ms']:.4f} / route 0 "
        f"{rows['softmax_fwd']['bert']['general_ms']:.4f} ms, torch.softmax "
        f"{rows['softmax_fwd']['bert']['library_ms']:.4f}, bound "
        f"{bb_:.5f} ({bby_})")
    del yk, yp, xb3, mb, mbytes, y_rows, y_general, yp32, xbm, rows_bert
    del general_bert
    for r in rows.values():
        r["max_abs_err"] = max(errs[r["name"]])
        log(f"kernel {r['name']}: {r['ms']:.4f} ms (eager "
            f"{r['eager_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']:.4f} ms ({r['library']}), bound "
            f"{r['bound_ms']:.5f} ms ({r['bound_by']}) at {r['shape']}")

    # the main path: FusedScaleMaskSoftmax, fused (the kernels) and unfused
    gpt_x = rand(SM_GPT, torch.bfloat16).requires_grad_(True)
    bert_x = xb.requires_grad_(True)
    fused = {kind: FusedScaleMaskSoftmax(attn_mask_type=kind, scale=0.125)
             for kind in (AttnMaskType.causal, AttnMaskType.padding)}
    unfused = {kind: FusedScaleMaskSoftmax(
        attn_mask_type=kind, scaled_masked_softmax_fusion=False, scale=0.125)
        for kind in fused}
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = {}
    with softmax_routes() as seen:
        for kind, x, m in ((AttnMaskType.causal, gpt_x, None),
                           (AttnMaskType.padding, bert_x, pad)):
            y = fused[kind](x, m)
            (dx,) = torch.autograd.grad(y.float().square().sum(), x)
            outs[kind] = (y.detach(), dx)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    log(f"FusedScaleMaskSoftmax fused, causal 355M + padding BERT, forward "
        f"and backward: {wall * 1e3:.1f} ms, launches "
        f"{ {k: v for k, v in counts.items() if v} }, forward routes {seen}")
    check(counts["softmax_fwd"] == 2 and counts["softmax_bwd"] == 2,
          f"FusedScaleMaskSoftmax: softmax launches {counts['softmax_fwd']}"
          f" / {counts['softmax_bwd']}, expected 2 / 2")
    check(seen == [1, 1], f"FusedScaleMaskSoftmax: forward routes {seen}, "
          f"expected [1, 1] (the row-in-registers kernel)")
    others = {k: v for k, v in counts.items()
              if v and k not in ("softmax_fwd", "softmax_bwd")}
    check(not others, f"FusedScaleMaskSoftmax: other kernels: {others}")
    live = torch.ones(SM_BERT[0], dtype=torch.bool, device=dev)
    live[:SM_BERT_MASKED] = False
    for kind, x, m in ((AttnMaskType.causal, gpt_x, None),
                       (AttnMaskType.padding, bert_x, pad)):
        y, dx = outs[kind]
        # the wiring: dx is the plain backward of the residual the fused
        # forward saved (bf16 y as it is; for fp16, the fp32 y before the
        # narrowing) at dy = 2y, rounded once to x's dtype
        x3 = x.detach().reshape(-1, *x.shape[-2:])
        causal = kind == AttnMaskType.causal
        y_res = y.reshape(x3.shape) if x.dtype == torch.bfloat16 else \
            softmax_fwd_plain(x3.float(), None if m is None else
                              _mask3(m, x.detach()), 0.125, causal)
        d_ref = softmax_bwd_plain(y_res, (2 * y).reshape(x3.shape).to(
            y_res.dtype), 0.125).to(x.dtype).reshape(x.shape)
        check(ulp_close(dx, d_ref),
              f"FusedScaleMaskSoftmax {kind.name}: gradient vs the plain "
              f"backward of its residual err {max_err(dx, d_ref)}")
        del y_res, d_ref
        yu = unfused[kind](x, m)
        (du,) = torch.autograd.grad(yu.float().square().sum(), x)
        yu, du = yu.detach(), du
        if kind == AttnMaskType.padding:
            # fully masked rows: zeros fused, uniform 1/sk unfused
            check(torch.equal(yu[~live].float(), torch.full_like(
                yu[~live].float(), 1.0 / SM_BERT[3])),
                "unfused softmax: a fully masked row is not 1/sk")
            y, yu, dx, du = y[live], yu[live], dx[live], du[live]
        check(ulp_close(y, yu),
              f"FusedScaleMaskSoftmax {kind.name}: fused vs unfused err "
              f"{max_err(y, yu)}")
        # the fused backward reads the saved y in the working dtype, the
        # unfused one differentiates the fp32 chain: y's rounding, which
        # dx = s*y*(dy - sum(y*dy)) can cancel down to, gives bf16 errors
        # of about 1.3% of max|du|. A band of 2^-5 of max|du| plus one ulp
        # of each entry, so a zero or sign-flipped gradient fails
        tol = dict(atol=2.0 ** -5 * float(du.float().abs().max()),
                   rtol=ULP[x.dtype])
        check(close(dx, du, tol),
              f"FusedScaleMaskSoftmax {kind.name}: gradient err "
              f"{max_err(dx, du)}")
        log(f"FusedScaleMaskSoftmax {kind.name}: fused vs unfused max err "
            f"{max_err(y, yu):.3e}, gradients {max_err(dx, du):.3e}")
    del gpt_x, bert_x, outs, xb
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows, counts


# ---------------------------------------------------------------------------
# phase 31: the 355M trainer with FusedAdagrad
# ---------------------------------------------------------------------------

ADAGRAD_STEPS = 3


def phase_adagrad_train(tcfg, layout, tok, tgt):
    """Phase 31: bench.py main()'s 355M step through
    ``make_train_step(cfg, fused_adagrad(1e-2, layout=layout))``: one
    warm-up and ``ADAGRAD_STEPS`` timed steps, launch counts zeroed just
    before and read just after; ``adagrad_flat`` once per group per step
    in the flat layout, never in the tree layout. Returns the metrics."""
    from apex_tpu_torch import multi_tensor as mt
    from apex_tpu_torch.amp import ScalerConfig
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import make_train_step
    from apex_tpu_torch.optimizers import fused_adagrad

    init_fn, step_fn = make_train_step(
        tcfg, fused_adagrad(1e-2, layout=layout), ScalerConfig(enabled=False))
    state = init_fn(torch.Generator("cuda").manual_seed(0))
    groups = mt.layout_of(state.params).num_groups
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    state, m = step_fn(state, tok, tgt)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ADAGRAD_STEPS):
        state, m = step_fn(state, tok, tgt)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    del state
    torch.cuda.empty_cache()
    losses = [float(x) for x in losses]
    n_steps = ADAGRAD_STEPS + 1
    metrics = dict(
        layout=layout, step_ms=wall / ADAGRAD_STEPS * 1e3,
        train_tokens_per_sec=ADAGRAD_STEPS * tok.numel() / wall,
        peak_memory_bytes=torch.cuda.max_memory_allocated(), losses=losses,
        groups=groups, launches=counts,
        launches_per_step={k: v / n_steps for k, v in counts.items() if v})
    log(f"train 355M FusedAdagrad {layout}: " + json.dumps(metrics))
    check(all(np.isfinite(losses)), f"Adagrad {layout}: non-finite loss")
    want = groups * n_steps if layout == "flat" else 0
    check(counts["adagrad_flat"] == want,
          f"Adagrad {layout}: adagrad_flat launched {counts['adagrad_flat']}"
          f" times, expected {want}")
    L = tcfg.num_layers
    check(counts["flash_attention_bsh"] == L * n_steps
          and counts["flash_attention_bsh_bwd"] == L * n_steps,
          f"Adagrad {layout}: flash launches {counts['flash_attention_bsh']}"
          f" / {counts['flash_attention_bsh_bwd']}, expected {L * n_steps}")
    check_tc(f"Adagrad {layout}", counts, "flash_attention_bsh")
    check_tc(f"Adagrad {layout} backward", counts, "flash_attention_bsh_bwd")
    return metrics


# ---------------------------------------------------------------------------
# phase 32: the apex L3 loop on the 355M
# ---------------------------------------------------------------------------

L3_STEPS = 3
#: the L3 loop's Adagrad learning rate. Adagrad's first step moves every
#: weight by about lr (g / sqrt(g^2)); at the JAX default of 1e-2 (phase
#: 31's) that is half the 355M's init scale, and the mean micro-batch loss
#: on the repeated batch swings over four steps (11.04, 11.06, 9.90,
#: 12.66 on an H100; 11.04, 10.87, 12.71, 11.22 at 1e-3); at 3e-4 it falls
#: every step (11.04, 10.85, 10.54, 10.31)
L3_LR = 3e-4


def _l3_step(tcfg, params, state, tx, tok, tgt, poison=False):
    """One step of the loop apex users write: per micro-batch (two of
    half the batch) the gradient of ``loss * S`` by ``torch.autograd``;
    the first unscaled into the accumulator by ``MultiTensorApply`` with
    ``scale_flat`` (a = 1/S), the second added by ``axpby_flat(1/S, g, 1,
    acc)``; ``clip_grad_norm_(acc, 1.0)``; a flat FusedAdagrad step with
    the overflow flag as ``skip``. ``poison`` puts an inf into one
    gradient leaf of the second micro-batch. Returns (params, state,
    losses, found_inf, pre-clip norm)."""
    from apex_tpu_torch import _tree
    from apex_tpu_torch.contrib import clip_grad_norm_
    from apex_tpu_torch.kernels import axpby_flat, scale_flat
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.multi_tensor import MultiTensorApply

    leaves, spec = _tree.flatten(params)
    mta = MultiTensorApply()
    acc, losses, found = None, [], None
    half = tok.shape[0] // 2
    for i in range(2):
        sl = slice(i * half, (i + 1) * half)
        diff = [x.detach().requires_grad_(True) for x in leaves]
        loss = gpt.loss(tcfg, _tree.unflatten(spec, diff), tok[sl], tgt[sl])
        grads = list(torch.autograd.grad(loss * L3_SCALE, diff))
        losses.append(loss.detach())
        del diff, loss
        if poison and i == 1:
            grads[0].view(-1)[3] = float("inf")
        if acc is None:
            [acc], f = mta(scale_flat, None, [grads], 1.0 / L3_SCALE)
        else:
            [acc], f = mta(lambda x, y: axpby_flat(1.0 / L3_SCALE, x, 1.0, y),
                           None, [grads, acc])
        found = f if found is None else found | f
        del grads
    clipped, norm = clip_grad_norm_(_tree.unflatten(spec, acc), 1.0)
    del acc
    params, state = tx.step(clipped, state, params, skip=found)
    return params, state, losses, found, norm


def phase_l3_loop(tcfg, tok, tgt):
    """Phase 32: the apex L3 loop (``_l3_step``, Adagrad at ``L3_LR``) on
    the 355M at batch 16 in two micro-batches of 8: one warm-up and
    ``L3_STEPS`` timed steps,
    launch counts zeroed before and read after (per step: ``scale_flat``
    twice per group, ``axpby_flat``, ``l2norm_flat`` and ``adagrad_flat``
    once per group), losses finite and falling; then one step with an
    inf in a gradient leaf: flagged, skipped, params and the sum of
    squares bit-equal. Returns the metrics."""
    from apex_tpu_torch import _tree
    from apex_tpu_torch import multi_tensor as mt
    from apex_tpu_torch.kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import gpt
    from apex_tpu_torch.optimizers import fused_adagrad

    params = gpt.init(tcfg, torch.Generator("cuda").manual_seed(0))
    tx = fused_adagrad(L3_LR, layout="flat")
    state = tx.init(params)
    groups = mt.layout_of(params).num_groups
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    params, state, losses, found, norm = _l3_step(tcfg, params, state, tx,
                                                  tok, tgt)
    all_losses, flags, norms = [losses], [found], [norm]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(L3_STEPS):
        params, state, losses, found, norm = _l3_step(tcfg, params, state,
                                                      tx, tok, tgt)
        all_losses.append(losses)
        flags.append(found)
        norms.append(norm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_steps = L3_STEPS + 1
    losses = [[float(x) for x in step] for step in all_losses]
    metrics = dict(
        step_ms=wall / L3_STEPS * 1e3,
        train_tokens_per_sec=L3_STEPS * tok.numel() / wall,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        losses=losses, grad_norms=[float(x) for x in norms],
        found_inf=[bool(x) for x in flags], groups=groups,
        launches_per_step={k: v / n_steps for k, v in counts.items() if v})
    log("apex L3 loop 355M: " + json.dumps(metrics))
    flat_losses = [x for step in losses for x in step]
    check(all(np.isfinite(flat_losses)), "L3 loop: non-finite loss")
    check(not any(metrics["found_inf"]), "L3 loop: a clean step was flagged")
    check(np.mean(losses[-1]) < np.mean(losses[0]),
          f"L3 loop: the loss did not fall ({losses[0]} -> {losses[-1]})")
    for name, per_step in (("scale_flat", 2 * groups),
                           ("axpby_flat", groups), ("l2norm_flat", 1),
                           ("adagrad_flat", groups)):
        check(counts[name] == per_step * n_steps,
              f"L3 loop: {name} launched {counts[name]} times, expected "
              f"{per_step} x {n_steps}")
    keep_p = [x.clone() for x in _tree.leaves(params)]
    keep_h = [x.clone() for x in state.sum_sq]
    count = int(state.count)
    params, state, _, found, _ = _l3_step(tcfg, params, state, tx, tok, tgt,
                                          poison=True)
    torch.cuda.synchronize()
    check(bool(found), "L3 loop: an inf gradient was not flagged")
    check(int(state.count) == count, "L3 loop: a skipped step counted")
    check(all(torch.equal(a, b) for a, b in zip(_tree.leaves(params),
                                                keep_p))
          and all(torch.equal(a, b) for a, b in zip(state.sum_sq, keep_h)),
          "L3 loop: a skipped step changed params or the sum of squares")
    log("apex L3 loop: the step with an inf gradient was flagged and "
        "skipped; params and h bit-equal")
    del params, state, keep_p, keep_h
    gc.collect()
    torch.cuda.empty_cache()
    return metrics, counts


def main() -> int:
    t0 = time.perf_counter()
    try:
        device_kind, card = phase_device()
        phase_build()
        rows = phase_kernels()
        from apex_tpu_torch.models import gpt

        cfg = model_config()
        params = gpt.init(cfg, torch.Generator("cuda").manual_seed(0))
        t = time.perf_counter()
        band = 3 * phase_model(cfg, params)
        log(f"model phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        counts, _, engine, streams = phase_path(cfg, params, band)
        log(f"path phase {time.perf_counter() - t:.1f}s")
        prof5 = phase_profile(cfg, engine)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        # the paged and speculative paths, on the same serving model
        t = time.perf_counter()
        paged_rows = phase_paged_kernels()
        log(f"paged/spec kernels phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        paged_counts, _ = phase_paged_path(cfg, params, band, streams)
        log(f"paged path phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        spec_writes, _ = phase_spec(cfg, params, band)
        log(f"spec phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        paged_spec_writes = phase_paged_spec(cfg, params)
        log(f"paged+spec phase {time.perf_counter() - t:.1f}s")
        # prefix reuse, chunked prefill and the pipelined scheduler
        t = time.perf_counter()
        prefix_launches, _ = phase_prefix_chunked(cfg, params, band, card)
        log(f"prefix/chunked phase {time.perf_counter() - t:.1f}s")
        # the serving front end: the HTTP server, stop strings, schema
        # constraints, tenants
        t = time.perf_counter()
        api_launches, _ = phase_api(cfg, params, band, card, prof5)
        log(f"front-end phase {time.perf_counter() - t:.1f}s")
        # beam search and multi-LoRA serving
        t = time.perf_counter()
        beam_launches, lora_launches, lora_spec_launches, _ = \
            phase_beam_lora(cfg, params, band, card, prof5)
        log(f"beam/LoRA phase {time.perf_counter() - t:.1f}s")
        # the host-swap tier: park/resume, preemption, adapter paging
        t = time.perf_counter()
        hs_launches, _ = phase_hostswap(cfg, params, band, card, prof5)
        log(f"host-swap phase {time.perf_counter() - t:.1f}s")
        # serving telemetry and the self-tuning scheduler
        t = time.perf_counter()
        tl_launches, _ = phase_telemetry(cfg, params, band, card, prof5)
        log(f"telemetry phase {time.perf_counter() - t:.1f}s")
        # the quantized cache, on the same serving model
        t = time.perf_counter()
        quant_rows = phase_quant_kernels()
        log(f"quant kernels phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        width_rows = phase_decode_widths()
        log(f"decode widths phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        quant_err = phase_quant_logits(cfg, params)
        quant_launches, _ = phase_quant_serving(cfg, params, band,
                                                quant_err)
        log(f"quant serving phase {time.perf_counter() - t:.1f}s")
        # the training phases' peak memory is the train step's own
        del params
        gc.collect()
        torch.cuda.empty_cache()

        t = time.perf_counter()
        tcfg = train_config()
        train_rows, fwd_train = phase_train_kernels(tcfg)
        log(f"training kernels phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        tok, tgt = train_batch(tcfg)
        params = gpt.init(tcfg, torch.Generator("cuda").manual_seed(0))
        phase_grads(tcfg, params, tok, tgt)
        del params
        torch.cuda.empty_cache()
        log(f"grads phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        flat, state, step_fn = phase_train(tcfg, "flat", tok, tgt)
        phase_train_profile("flat", state, step_fn, (tok, tgt))
        del state, step_fn
        torch.cuda.empty_cache()
        tree, state, step_fn = phase_train(tcfg, "tree", tok, tgt)
        phase_train_profile("tree", state, step_fn, (tok, tgt))
        del state, step_fn
        gap = max(abs(a - b) for a, b in zip(flat["losses"], tree["losses"]))
        log(f"train: flat vs tree max|loss diff| over "
            f"{len(flat['losses'])} steps = {gap:.3e} (band "
            f"{LAYOUT_LOSS_BAND})")
        check(gap <= LAYOUT_LOSS_BAND,
              f"train: flat and tree losses differ by {gap}")
        check(flat["losses"][0] == tree["losses"][0],
              "train: the first step's losses differ between the layouts")
        log(f"train phase {time.perf_counter() - t:.1f}s")
        gc.collect()
        torch.cuda.empty_cache()

        # the BERT slice: kernels, gradients, runs (a) and (b), profile
        t = time.perf_counter()
        bcfg_a = bert_config(ln_impl="pallas")
        bert_rows, bert_extra = phase_bert_kernels(bcfg_a)
        log(f"BERT kernels phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        from apex_tpu_torch.models import bert

        batch = bert_batch(bcfg_a)
        params = bert.init(bcfg_a, torch.Generator("cuda").manual_seed(0))
        phase_bert_grads(bcfg_a, params, *batch)
        del params
        torch.cuda.empty_cache()
        log(f"BERT grads phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        run_a, state, step_fn = phase_bert_train(bcfg_a, "flat", *batch)
        phase_train_profile("BERT flat", state, step_fn, batch)
        del state, step_fn
        torch.cuda.empty_cache()
        run_b, state, step_fn = phase_bert_train(bert_config(), "tree",
                                                 *batch)
        del state, step_fn
        torch.cuda.empty_cache()
        gap = max(abs(a - b) for a, b in zip(run_a["losses"],
                                             run_b["losses"]))
        log(f"BERT: runs (a) and (b) max|loss diff| over "
            f"{len(run_a['losses'])} steps = {gap:.3e} (band "
            f"{BERT_LOSS_BAND})")
        check(gap <= BERT_LOSS_BAND,
              f"BERT: runs (a) and (b) losses differ by {gap}")
        log(f"BERT train phase {time.perf_counter() - t:.1f}s")

        # the rest of single-chip training: the fused cross entropy, BERT
        # in fp16 and ResNet-50 with FusedSGD
        t = time.perf_counter()
        xent_rows, fp16_extra = phase_xent_kernels(tcfg, bcfg_a)
        log(f"xentropy and fp16 flash kernels phase "
            f"{time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        fused_run = phase_fused_ce_train(tcfg, tok, tgt, tree)
        log(f"fused CE train phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        bert16 = phase_bert_fp16(*batch)
        log(f"BERT fp16 phase {time.perf_counter() - t:.1f}s")
        del batch
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        from apex_tpu_torch.models import resnet

        rcfg = resnet.ResNetConfig()
        sgd_row = phase_sgd_kernel(rcfg)
        images, labels = resnet_batch()
        r_flat, state = phase_resnet_train(rcfg, "flat", images, labels)
        del state
        torch.cuda.empty_cache()
        r_tree, state = phase_resnet_train(rcfg, "tree", images, labels)
        del state
        gaps = [abs(a - b) for a, b in zip(r_flat["losses"],
                                           r_tree["losses"])]
        held = max(gaps[:RESNET_HELD_STEPS])
        log(f"ResNet-50: flat vs tree max|loss diff| over the first "
            f"{RESNET_HELD_STEPS} steps = {held:.3e} (band "
            f"{RESNET_LAYOUT_BAND}), over all {len(gaps)} = "
            f"{max(gaps):.3e}")
        check(held <= RESNET_LAYOUT_BAND,
              f"ResNet-50: flat and tree losses differ by {held}")
        check(r_flat["losses"][0] == r_tree["losses"][0],
              "ResNet-50: the first step's losses differ between layouts")
        sgd_launches = r_flat["launches"]["sgd_flat"]
        log(f"ResNet phase {time.perf_counter() - t:.1f}s")
        del r_flat, r_tree, images, labels
        gc.collect()
        torch.cuda.empty_cache()

        # the head-major flash attention: Megatron-GPT 2.7B (heads of 80)
        t = time.perf_counter()
        hm_rows = phase_hm_kernels()
        log(f"head-major kernels phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        phase_2p7b_grads()
        log(f"2.7B grads phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        fused_2p7b, split_2p7b = phase_2p7b_train()
        log(f"2.7B train and profile phases {time.perf_counter() - t:.1f}s")
        # serve the 2.7B once its training state is freed
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        serve_2p7b, serve_2p7b_counts = phase_2p7b_serve()
        log(f"2.7B serving phases {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        phase_bhsd_355m(tcfg, tok, tgt, tree)
        log(f"355M bhsd phase {time.perf_counter() - t:.1f}s")

        # the apex L3 surface: the flat sweeps, the fused softmax, the
        # 355M trainer with FusedAdagrad and the L3 loop
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        l3_rows = phase_l3_flat_kernels(tcfg)
        log(f"L3 flat kernels phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        sm_rows, sm_counts = phase_softmax()
        log(f"softmax phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        ada = {lay: phase_adagrad_train(tcfg, lay, tok, tgt)
               for lay in ("flat", "tree")}
        gap = max(abs(a - b) for a, b in zip(ada["flat"]["losses"],
                                             ada["tree"]["losses"]))
        log(f"Adagrad: flat vs tree max|loss diff| over "
            f"{len(ada['flat']['losses'])} steps = {gap:.3e} (band "
            f"{LAYOUT_LOSS_BAND})")
        check(gap <= LAYOUT_LOSS_BAND,
              f"Adagrad: flat and tree losses differ by {gap}")
        check(ada["flat"]["losses"][0] == ada["tree"]["losses"][0],
              "Adagrad: the first step's losses differ between the layouts")
        log(f"Adagrad train phase {time.perf_counter() - t:.1f}s")
        t = time.perf_counter()
        _, l3_counts = phase_l3_loop(tcfg, tok, tgt)
        log(f"L3 loop phase {time.perf_counter() - t:.1f}s")
    except SmokeFailure as e:
        log(f"FAILED: {e}")
        return 1
    for r in rows.values():
        r["launches"] = counts[r["name"]]
    rows["flash_attention_bsh"]["launches_tc"] = counts[
        "flash_attention_bsh_tc"]
    for r in paged_rows.values():
        r["launches"] = paged_counts.get(r["name"], 0)
    # rows 7, 10 and 13, 17 run on the main path inside the fused launch:
    # their launches are its launches, their own wrappers' count beside
    for fused, names, table, run in (
            ("decode_attention_write", ("decode_write_column",
                                        "decode_attention"), rows, counts),
            ("paged_attention_write", ("paged_write_column",
                                       "paged_attention"), paged_rows,
             paged_counts)):
        for name in names:
            table[name].update(
                standalone_launches=run[name], launches=run[fused],
                main_path=f"in the read's launch ({fused})")
    # rows 8 and 15 run on the verify's main path inside its launch: their
    # launches are its launches, their own wrappers' count beside (0)
    for name, fused, run in (
            ("cache_write_columns", "decode_verify_attention",
             spec_writes["high"]),
            ("paged_write_columns", "paged_verify_attention",
             paged_spec_writes)):
        paged_rows[fused]["launches"] = run[fused]
        paged_rows[name].update(
            standalone_launches=run[name], launches=run[fused],
            main_path=f"in the verify's launch ({fused})")
    for name in ("cache_write_columns", "decode_verify_attention"):
        paged_rows[name]["launches_adv"] = spec_writes["adv"][
            "decode_verify_attention"]
    rows.update(paged_rows)
    # phase 36's runs: row 5 for cold groups and chunk 0s, rows 10 and 17
    # (in their fused launches) and 15v under prefix hits
    for names, fused in ((("flash_attention_bsh",), "flash_attention_bsh"),
                         (("decode_attention", "decode_attention_write"),
                          "decode_attention_write"),
                         (("paged_attention", "paged_attention_write"),
                          "paged_attention_write"),
                         (("paged_write_columns", "paged_verify_attention"),
                          "paged_verify_attention")):
        for name in names:
            rows[name]["launches_prefix_chunked"] = prefix_launches[fused]
    # phase 37's path: row 5 for every admission, row 10 (in its fused
    # launch) for every decode step
    for name, fused in (("flash_attention_bsh", "flash_attention_bsh"),
                        ("decode_attention", "decode_attention_write"),
                        ("decode_attention_write", "decode_attention_write")):
        rows[name]["api_launches"] = api_launches[fused]
    # phase 38's runs: row 5 for the beam prefill and every LoRA
    # admission, row 10 (in its fused launch) for every beam step and every
    # LoRA decode step; rows 17 and 15v (and the fused paged step) in (c)
    for name, fused in (("flash_attention_bsh", "flash_attention_bsh"),
                        ("decode_attention", "decode_attention_write"),
                        ("decode_attention_write", "decode_attention_write")):
        rows[name]["beam_launches"] = beam_launches[fused]
        rows[name]["lora_launches"] = lora_launches[fused]
    for name, fused in (("paged_attention", "paged_attention_write"),
                        ("paged_attention_write", "paged_attention_write"),
                        ("paged_verify_attention", "paged_verify_attention")):
        rows[name]["lora_launches"] = lora_spec_launches[fused]
    for r in quant_rows.values():
        r["launches"] = quant_launches[r["name"]]
    rows.update(quant_rows)
    # phase 39's runs: row 5 for every admission group, rows 13 + 17 (the
    # fused paged step) for every decode step, 15v for every wave of (d),
    # rows 14 + 18 and 16 for (b)'s int8 steps and waves
    for name, fused in (("flash_attention_bsh", "flash_attention_bsh"),
                        ("paged_attention", "paged_attention_write"),
                        ("paged_write_column", "paged_attention_write"),
                        ("paged_attention_write", "paged_attention_write"),
                        ("paged_write_columns", "paged_verify_attention"),
                        ("paged_verify_attention", "paged_verify_attention"),
                        ("paged_write_column_quant",
                         "paged_write_column_quant"),
                        ("paged_attention_quant", "paged_attention_quant"),
                        ("paged_write_columns_quant",
                         "paged_write_columns_quant")):
        rows[name]["hostswap_launches"] = hs_launches[fused]
    # phase 40's runs: row 5 for every admission group, rows 7 + 10 (the
    # fused contiguous step) for (a)'s and (d)'s decode steps, rows 13 + 17
    # (the fused paged step) and 15v for (b)'s steps and waves
    for name, fused in (("flash_attention_bsh", "flash_attention_bsh"),
                        ("decode_write_column", "decode_attention_write"),
                        ("decode_attention", "decode_attention_write"),
                        ("decode_attention_write", "decode_attention_write"),
                        ("paged_write_column", "paged_attention_write"),
                        ("paged_attention", "paged_attention_write"),
                        ("paged_attention_write", "paged_attention_write"),
                        ("paged_verify_attention", "paged_verify_attention")):
        rows[name]["telemetry_launches"] = tl_launches[fused]
    # the four reads at the 2.7B's decode shape, with their launches in
    # its serving trace (paged int8 for row 18); rows 10 and 17 with the
    # fused launch's, as on the 355M's path
    for name, side, fused in (
            ("decode_attention", "contiguous", "decode_attention_write"),
            ("paged_attention", "paged", "paged_attention_write")):
        rows[name]["2p7b"] = dict(
            width_rows[name], launches=serve_2p7b_counts[side][fused],
            standalone_launches=serve_2p7b_counts[side][name])
        rows[fused]["2p7b"]["launches"] = serve_2p7b_counts[side][fused]
    for name, side in (("decode_attention_quant", "int8"),
                       ("paged_attention_quant", "paged int8"),
                       ("decode_write_column_quant", "int8"),
                       ("paged_write_column_quant", "paged int8"),
                       ("cache_write_columns_quant", "int8"),
                       ("paged_write_columns_quant", "paged int8")):
        rows[name]["2p7b"] = dict(width_rows[name],
                                  launches=serve_2p7b_counts[side][name])
    for r in train_rows.values():
        r["launches"] = flat["launches"][r["name"]]
    train_rows["flash_attention_bsh_bwd"]["launches_tc"] = flat["launches"][
        "flash_attention_bsh_bwd_tc"]
    rows["flash_attention_bsh"]["train"] = dict(
        fwd_train, launches=flat["launches"]["flash_attention_bsh"],
        launches_tc=flat["launches"]["flash_attention_bsh_tc"])
    rows.update(train_rows)
    for kname, r in bert_extra.items():
        rows[kname]["bert"] = dict(r, launches=run_a["launches"][kname])
    for kname in ("flash_attention_bsh", "flash_attention_bsh_bwd"):
        rows[kname]["bert"]["launches_tc"] = run_a["launches"][f"{kname}_tc"]
    for r in bert_rows.values():
        r["launches"] = run_a["launches"][r["name"]]
    bert_rows["layer_norm_bwd"]["launches_route1"] = run_a["ln_bwd_route1"]
    rows.update(bert_rows)
    for r in xent_rows.values():
        r["launches"] = fused_run["launches"][r["name"]]
    rows.update(xent_rows)
    for kname, r in fp16_extra.items():
        rows[kname]["fp16"] = dict(r, launches=bert16["launches"][kname],
                                   launches_tc=bert16["launches"][
                                       f"{kname}_tc"])
    sgd_row["launches"] = sgd_launches
    rows["sgd_flat"] = sgd_row
    # the head-major forward and fused backward from the 2.7B fused run,
    # the split pair from its APEX_TPU_FLASH_BWD=split run
    for name, run in (("flash_attention", fused_2p7b),
                      ("flash_attention_bwd", fused_2p7b),
                      ("flash_attention_bwd_dq", split_2p7b),
                      ("flash_attention_bwd_dkdv", split_2p7b)):
        hm_rows[name]["launches"] = run["launches"].get(name, 0)
    for name, run in (("flash_attention", fused_2p7b),
                      ("flash_attention_bwd", fused_2p7b),
                      ("flash_attention_bwd_dq", split_2p7b),
                      ("flash_attention_bwd_dkdv", split_2p7b)):
        hm_rows[name]["launches_tc"] = run["launches"].get(f"{name}_tc", 0)
    rows.update(hm_rows)
    # scale and axpby from the L3 loop; adagrad from the flat FusedAdagrad
    # trainer (its L3-loop count beside); the softmax from
    # FusedScaleMaskSoftmax's run
    for name in ("scale_flat", "axpby_flat"):
        l3_rows[name]["launches"] = l3_counts[name]
    l3_rows["adagrad_flat"]["launches"] = ada["flat"]["launches"][
        "adagrad_flat"]
    l3_rows["adagrad_flat"]["launches_l3_loop"] = l3_counts["adagrad_flat"]
    rows["l2norm_flat"]["launches_l3_loop"] = l3_counts["l2norm_flat"]
    rows.update(l3_rows)
    for r in sm_rows.values():
        r["launches"] = sm_counts[r["name"]]
    rows.update(sm_rows)
    log(f"card: {card}")
    log(json.dumps({"kernels": list(rows.values())}))
    log(f"total {time.perf_counter() - t0:.1f}s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
