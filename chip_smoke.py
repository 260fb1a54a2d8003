#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each of which asserts; any failure exits non-zero:

1. device: require CUDA, print the card's name and power limit, turn TF32
   off for matmuls and cuDNN (both stated here: every comparison below is in
   full float32), build the CUDA kernels from ``src/repro_torch/kernels/csrc``
2. K1 ``union_segsum`` against its plain PyTorch version on the card, at
   the trainer's shapes, a wide shape, D = 18 and 25 (DIN's and the LSTM's
   widths), a hot cohort (one id in each of 1,000 clients) and the heavy
   shape (V = 2^22, 1,000 clients x 512 rows, D = 18), f32 and bf16, with
   and without heat, ids >= V, all-pad clients, an overflowing union, and
   two calls back to back on one V
3. K2 ``rowsparse_scatter`` against its plain version on the card, on the
   same kinds of cases
4. the main path at full width: LR FedSubAvg on MovieLens-1M-sized data
   (6,040 clients, 3,706 movies, ~1.0M ratings, V = 37,069 features),
   K = 100 clients per round, fedsubavg, fedavg and fedsubavg with top-16
   transport, 20 rounds each through ``run_round`` and ``run``; K1 must
   serve every round. K2's own path (``aggregate_rowsparse_dense``) follows
5. card against host: the same trainer for 5 rounds on ``device="cpu"``
   (the plain versions); losses and final parameters within 1e-5
6. K1 and K2 times (CUDA events) at the trainer's round and at the heavy
   shape (f32 and bf16) beside their plain versions, one PyTorch stand-in
   each and the HBM bound, with device ops and device time per call
   (torch.profiler: one op each), K1's scratch bytes, and the redesign's
   targets marked met or missed
7. where a round's time goes: host sampling, device kernel time and
   launches per round (torch.profiler), K1 in the round, the device's busy
   share
8. K3 ``flash_attention`` against its plain version on the card: the
   serving prefill's shape (B 4, S 1024, H 40, KV 8, hd 128) in bf16 (the
   ``wgmma`` kernel) and f32 (the 3xTF32 ``mma.sync`` kernel), a sliding
   window, every other head dim (16, 32; 64 in bf16, MHA at 64 in f32),
   non-causal, ragged lengths, a continuation (Sq not a multiple of 128,
   Sk > Sq, q_offset > 0) and a window whose edge falls inside a tile, the
   last four in both dtypes.
   Kernel against plain version throughout: 2e-5 in f32; 2e-2 in bf16, and
   also 1e-2 in relative norm
9. K4 ``flash_decode`` against its plain version: the decode step's shape
   (B 4, H 40, KV 8, 1,056 slots, hd 128) in bf16 and f32, a part-filled
   cache with -1 slots, a wrapped ring buffer with a window, and an empty
   row (every position above ``q_position``: the mean of V)
10. the serving path at full size: Qwen2.5-14B from its published config
    (48 layers, bf16, random weights from seed 0) through
    ``repro_torch.launch.serve``: prefill of 4 x 1,024 tokens, then 32
    greedy decode steps; K3 must serve 48 launches in prefill and K4 48 per
    decode step; logits finite
11. card against host: the same model at full width with 2 layers in f32,
    1 x 256 prompt tokens and 8 decode steps, on the card and on
    ``device="cpu"``; logits within 1e-4, greedy tokens identical
12. K3 and K4 times at the serving path's own inputs (recorded in an
    untimed rerun of [10]'s request) beside their plain versions,
    ``scaled_dot_product_attention`` and the bound, with the achieved
    TFLOP/s (K3) and TB/s (K4)
13. where a decode step's time goes (torch.profiler), K4's split pass per
    launch, the device's busy share
14. where a prefill's time goes (torch.profiler over one prefill of
    4 x 1,024 tokens): device time by op, K3's total over its 48 launches,
    the matmuls' total, the device's busy share
15. DIN FedSubAvg at the width of the DIN paper's Amazon Electronics
    (63,001 goods, ~9 samples per user; 2,000 of its 192,403 users, a cut
    printed on a ``reduced:`` line; emb 18, hidden 36): fedsubavg and
    fedavg, 20 rounds each, as in [4]; K1 (D = 18) must serve every round
    once, and is held to its plain version on one round's inputs
16. the same for the LSTM on Sent140-like data (1,000 clients, a
    20,000-word vocabulary, 24 tokens; emb 25, hidden 100, two cells):
    K1 at D = 25
17. card against host: DIN and the LSTM on 200 clients, fedsubavg and
    fedavg, 3 rounds each; losses and parameters within 1e-5
18. where a DIN and an LSTM fedsubavg round's time goes, as [7], and K1's
    times at each round's own inputs, as [6]
19. the paper's Table 2 algorithms at [4]'s configuration, 20 rounds each
    as in [4]: scaffold (``server_lr`` 1.0) and fedadam (0.03) on the
    sparse plan, where K1 must serve every round (no heat, scale 1/K, held
    to its plain version on one scaffold round's inputs); the same two and
    fedsubavg on the dense plan and central SGD, where K1 must not launch.
    Train loss falls and AUC > 0.5 in every run; their order is printed.
    Where a round's time goes on each new path, as [7]
20. private and weighted heat: fedsubavg on the sparse plan for 10 rounds
    under randomized response, randomized response with weights and exact
    heat with weights (K1 every round, losses finite); the heat's resolve
    time on the host, its numpy peak (tracemalloc) and the process's peak
    resident memory (getrusage)
21. card against host: 3 rounds of sparse scaffold and fedadam, dense
    fedsubavg, central and randomized-response fedsubavg on 200 clients of
    [4]'s data; losses, parameters and optimizer slots within 1e-5
22. the paper's Table 2 and Table 3 protocols (``tools/paper_tables.py``)
    on the dense and the sparse plan, printed as tables
23. ``ReplicatedLocal x RowSparseTransport`` (``sparse_local="replicated"``:
    K dense replicas, rows gathered from their deltas) through the trainer
    at [4]'s configuration, fedsubavg and fedavg, 20 rounds each as in [4];
    K1 must serve every round and is held to its plain version on one
    round's inputs; losses against [4]'s submodel-replica runs of the same
    seed (the same deltas on the touched rows); one round's profile, as [7]
24. int8 rows (``sparse_int8=True``) through the trainer at [4]'s
    configuration, alone and with top-16, on the submodel and the replicated
    plan, 20 rounds each; K1 every round, loss falls, AUC > 0.5; uplink
    bytes per round beside the f32 plans'; unbiased rounding on the card
    (the mean of 256 dequantised draws against the rows, in standard errors)
25. ``make_round_step`` on the LSTM at [16]'s width in its four modes,
    fedsgd with 4 microbatches, an int8 ``FedSgdLocal`` plan and an int8
    ``sparse_replicated`` plan, 3 steps each (K1 once per step on the two
    ``sparse_replicated`` plans only, held to its plain version on an int8
    step at D = 25); ``debug_checks``
    on and off equal bit for bit, a planted unsorted ``sub_ids`` raises;
    gather before backward with the table widened to V = 2^22: the step's
    peak device memory stays below the parameters plus one (V, D) table
26. card against host, 3 rounds on 200 clients of [4]'s data: the
    replicated plan, int8 rows with the noise drawn on the host and copied
    to the card (submodel and replicated), ``make_round_step``
    fedsgd, sparse and int8 ``sparse_replicated`` (the noise from the
    host) on the LSTM at 200 clients of [16]'s data; losses and
    parameters within 1e-5, except the int8 plan's table, which is held
    step by step instead (each step's int8 rounding and K1 on the card
    against the host's, from the host's deltas, within 1e-5: a ulp of
    difference between the two sides' deltas can move a rounding by one
    quantum); Example 1's condition numbers (``core/preconditioner.py``)
27. round telemetry at [4]'s configuration: 20 rounds through ``run`` and
    20 through ``run(engine=True)``, telemetry on (a JSONL ``TraceSink``),
    off and off again, K1 20 of 20 per run; on against off: the records
    within 1e-6 and the parameters within 1e-5 (K1's atomic order on rows
    scaled by up to N / n_m moves them by a few 1e-6 between any two runs;
    the second off run shows it); every
    round's heat histogram sums to its union, no id dropped at the pow2
    capacity; the sink reads back; ``compile_time`` booked in exactly the
    stretches with a first dispatch; ms and device ops per round on and
    off; [25]'s sparse ``FedSgdLocal`` LSTM step (no K1) on and off bit for
    bit under deterministic algorithms; a planted capacity of 16 through
    ``build_round_step``: the drop counts equal a numpy count
28. ``run(2, profile_dir=...)``: one trace file, its ``rounds[a:b]`` range
    and as many K1 events as K1's launch counter rose by
29. the buffered-async engine at [4]'s configuration: (a) zero delay with
    ``buffer_size = K`` against ``run_rounds(10)`` within 1e-5 (K1 10 of
    10 fires, the next numpy draw equal); (b) 20 lognormal waves with
    stragglers and dropouts, 25-arrival buffers, polynomial staleness and
    EMA heat: K1 once per fire, each fire's staleness histogram sums to 25,
    loss falls, AUC > 0.5, rows only dropped clients touch unchanged; ms
    per event and per fire, device ops per dispatch group, arrival group
    and fire (a profiled rerun), K1 at the fire's shape; (c) the same with
    100-arrival buffers and constant weights
30. card against host: (b)'s schedule over 6 waves of K = 20 on 200
    clients with telemetry and a non-binding top-k: losses, parameters,
    EMA heat and telemetry within 1e-5 (integers equal); a mid-run
    checkpoint saved on the card and resumed on the host equals the
    uninterrupted host run within 1e-5
31. cohort-sharded rounds (``FederatedTrainer(mesh=...)``): LR at [4]'s
    configuration, fedsubavg and fedavg (``auto``: psum) and fedsubavg
    with ``combine="union"``, 20 rounds each, on 1 rank (NCCL), 2 and 4
    ranks (gloo on the card's tensors: the machine has one card and NCCL
    refuses two ranks on one device), spawned with a bounded join; K1 once
    per rank per round under psum, once per rank more under union (the
    partial, then one call per further rank); losses, train loss and
    parameters within 1e-5 of the unsharded trainer on the card, every
    rank's parameters equal to rank 0's bit for bit; ms per round per
    world size (ranks sharing one card measure the machinery, not a
    speed-up); K1 at the shard partial's and the union combine's shapes
32. DIN at [15]'s configuration on 2 ranks, 10 rounds: ``auto`` picks the
    union combine at 63,001 x 18 f32, K1 twice per rank per round, as [31]
33. ``make_round_step`` on 2 ranks on [25]'s LSTM inputs: flat fedsgd and
    sparse, replicated, sparse_replicated and a 3-client cohort with
    ``debug_checks``, 3 steps each against the unsharded step on the card
    within 1e-5; every rank's collective counters equal
    ``round_collective_budget``'s components in every step
34. K3's backward (``flash_attention_bwd``, on the log-sum-exp K3's
    forward writes) against its plain version on the card: the training
    shape (B 16, S 128, H 40, KV 8, hd 128) and ragged, windowed, GQA
    (groups of 11 and 22 too), continuation and non-causal shapes, f32 and
    bf16 (2e-5 and 2e-2, as [8]), and the training shape in f32 with q
    scaled by 8 (a sharp softmax, where the 3xTF32 split's small terms
    carry the result), held elementwise against the plain version
    evaluated in f64: no further from it than the plain version's f32
    evaluation, whose own readings it prints;
    K3's log-sum-exp against the plain version's (2e-5 and 2e-2), +inf on
    the rows with no valid key of a case that has them; two backward calls
    bit for bit at the training shape and at the window; ``FlashAttention``
    under ``torch.func.grad`` and ``vmap(grad)`` over 3 clients against
    autograd of K3's plain version, one backward launch per call
35. the LLM main path: ``repro_torch.launch.train.train`` at Qwen2.5-14B's
    published widths (d_model 5,120, 40 / 8 heads, d_ff 13,824, vocab
    152,064, QKV bias) with 4 of its 48 layers (a cut printed on a
    ``reduced:`` line), f32, weights from seed 0, on
    ``make_lm_federated(256 clients, 128 tokens, 4 samples, zipf 1.3)``,
    cohort 16, lr 0.05: FedSgdLocal under fedsubavg and fedavg on the dense
    and the row-sparse transport, 10 rounds each; K3 and its backward 4
    times per round, K1 never; losses finite; ms per round, peak device
    memory, uplink bytes per round on the sparse transport
36. card against host: 1 layer at full width, cohort 2, 32 tokens, one
    round per transport from the same weights; loss and parameters within
    1e-4 (the sum order of 5,120- and 13,824-long f32 dot products, as [11])
37. ``make_round_step`` on the LLM at the reference's ``100m`` scale in its
    four modes, 3 steps each: K1 once per ``sparse_replicated`` step and
    never otherwise; the same at ``tiny`` on the card and on the host,
    losses and parameters within 1e-5
38. where a fedsubavg dense round of [35] goes (torch.profiler): device
    ops, busy share, device ms in matmuls, K3, K3's backward and the rest;
    K3 and its backward at the training shape by CUDA events beside their
    plain versions, SDPA (for the backward: autograd of
    ``scaled_dot_product_attention``, its forward subtracted) and the
    bound; the TFLOP/s of each (the backward's on its 5 products) and both
    bounds of each (the tensor-core route's, 3xTF32 at an effective 165
    TFLOP/s, and the f32 CUDA cores')
39. K3 and K4 against their plain versions at the new configurations'
    attention shapes, bf16 and f32 (H 64 / KV 8 of Qwen3-32B and
    DeepSeek-67B, H 96 / KV 8 of Mistral Large 123B at 4 x 1,024; Mixtral's
    H 48 / KV 8 with its window of 4,096 at 2 x 8,192, and K4 on its ring
    of 4,096 slots after 8,224 positions); K3's backward (f32) at GQA
    groups of 6 and 12 at [38]'s B 16 x S 128
40. Mixtral 8x22B serving at its published widths (8 of 56 layers, a cut
    printed on a ``reduced:`` line; bf16, random weights from seed 0)
    through ``launch.serve``: 2 prompts of 8,192 tokens, 32 greedy steps;
    K3 8 launches a prefill (the window binds), K4 8 a step on the wrapped
    ring, the cache at 8,224; prefill ms, ms per step against the step's
    weight-read bound, tok/s, peak memory, each prefill layer's
    ``expert_tokens``; then K3 and K4 at its own inputs timed as [12] does
    (SDPA with an explicit window mask, its backend named)
41. card against host, Mixtral at full width in f32: (a) 1 layer served,
    2 x 256 prompt tokens and 4 steps: logits within 1e-4, tokens and every
    MoE call's routing identical, the smallest gap between a token's k-th
    and (k+1)-th router probability printed; (b) ``moe`` alone under
    ``grad`` on (2, 256, 6,144): out, aux and the five gradients within
    1e-4 (and 1e-3 in relative norm), ``expert_tokens`` exact
42. Mixtral federated training through ``launch.train.train`` (1 of 56
    layers, f32, [35]'s corpus, cohort and lr): fedsubavg and fedavg dense
    and fedsubavg sparse, 5 rounds each; K3 and its backward once a round,
    K1 never; then ``make_round_step`` at the ``tiny`` scale (8 experts)
    in four modes with ``heat_expert``, card against host within 1e-5, K1
    once per ``sparse_replicated`` step; K3's backward at Mixtral's
    training shape (B 16, S 128, H 48, KV 8) timed as [38] does
43. Qwen3-32B, DeepSeek-67B and Mistral Large 123B at their published
    widths (2 layers each, bf16) through ``launch.serve``: 4 x 1,024 tokens
    and 8 greedy steps, ms and launches, finite logits; every registered
    configuration's ``abstract_params`` at full depth on ``meta``, its
    count ``param_counts()["total"]`` plus the leaves that count omits
44. K3 (bf16) at Qwen2-VL's and Llama 4's prefills (B 4 x S 2,048, H 28 /
    KV 4; B 2 x S 2,048, H 40 / KV 8) and K4 (bf16, f32) at their decode
    steps against their plain versions; K3's backward (f32) at GQA groups
    of 7 and 5 at [38]'s B 16 x S 128 and at Qwen2-VL's training shape
    (B 4, S 2,048, H 28, KV 4), its cluster the whole group, each timed as
    [38] times it
45. Qwen2-VL 7B served whole (28 layers, bf16, seed 0) through
    ``launch.serve``: 4 prompts of 2,048 positions, the first 1,024 random
    patch embeddings on a 32 x 32 image grid of M-RoPE streams (t 0, h
    i // 32, w i % 32), then 1,024 text tokens at 32 + j on all three
    streams; 32 greedy steps from the last position plus one; K3 28 a
    prefill, K4 28 a step; the step against its 4.55 ms weight-read bound;
    where a step's and a prefill's time goes; K3 and K4 at its own inputs
    timed as [12] does
46. Llama 4 Maverick at its published widths (2 of 48 layers, 128
    experts, top 1; bf16, seed 0, the experts drawn in slices): 2 prompts of 2,048 tokens, the first
    256 patches, 32 steps; each prefill layer's ``expert_tokens``; the
    drop-free step against every weight read once
47. card against host: one full-width f32 Qwen2-VL layer, 1 x 1,280
    positions with [45]'s image and streams, 4 steps, logits within 1e-4
    and tokens identical; Llama 4's smoke model in f32 with patches,
    logits within 1e-5, routing and ``expert_tokens`` identical, the
    smallest top-1 router gap printed
48. (a) Qwen2-VL through ``launch.train.train`` at its published widths in
    f32, 4 layers, cohort 4 at seq 2,048, each batch with the image's
    patches and streams: 3 rounds with remat off (K3 and its backward 4 a
    round) and on (K3 8, its backward 4), then the deepest depth one round
    trains at in each setting, 4 tries each; (b) ``make_round_step`` on the
    Qwen2-VL smoke model with ``mrope_pos``: 2 microbatches against 1 within
    rtol 2e-4 / atol 2e-5, remat on against off within 1e-5; (c) the Llama 4
    smoke model's ``make_round_step`` with patches and ``heat_expert`` in
    four modes, card against host within 1e-5, K1 once per
    ``sparse_replicated`` step
49.-53. Zamba2-1.2B and xLSTM-350M: K3, K4 and K3's backward at Zamba2's
    attention shape; both served whole (bf16, 4 x 1,024, 32 steps); card
    against host at 6 / 8 full-width f32 layers; both trained whole in f32
    (5 rounds, remat); their smoke models' ``sparse_replicated`` steps card
    against host, step by step
54. K3 (bf16 and f32) at Whisper large-v3's three attention shapes (H = KV
    = 20, hd 64): the encoder's 4 x 1,500 frames non-causal, cross-attention
    of a 224-token prompt to them (Sq 224, Sk 1,500, non-causal) and the
    decoder's causal 224; K4 (bf16 and f32) at its two decode attentions:
    the cross-attention cache of 1,500 slots, every one valid (the last
    tile holds 28), also as the first and the last layer's slice of a
    stacked (L, ...) cache, and the self-attention cache of 256 slots, full
    and part-filled; K3's backward (f32, cluster 1) at its training shapes
    (B 8: 1,500 x 1,500 and 448 x 1,500 non-causal, 448 causal). Each held
    to its plain version and timed beside it, SDPA (its backward for the
    backward) and the bound
55. Whisper large-v3 served whole (32 + 32 layers, 2,020,789,760 parameters,
    bf16, seed 0) through ``launch.serve``: 4 requests of 1,500 frames from
    a numpy seed and 224 prompt tokens, 32 greedy steps; K3 96 launches a
    prefill (32 layers x 3 uses), K4 64 a step; the prefill split into the
    encoder and the decoder, ms per step and tok/s, peak memory; the step
    against its read bound (the decoder's weights but cross-attention's
    ``wk`` and ``wv``, ``lm_head``, the cross-attention cache and the
    self-attention cache's valid slots), device ops and the busy share
56. card against host: 2 encoder and 2 decoder layers at full width, f32,
    1 x 1,500 frames, a 64-token prompt and 8 steps; logits within 1e-4,
    greedy tokens identical
57. Whisper large-v3 trained whole in f32 with remat through
    ``launch.train.train``: ``make_lm_federated(256 clients, 448 tokens,
    zipf 1.3)``, cohort 8, lr 0.05, 5 rounds, each with frames (8, 1,500,
    1,280) from a numpy seed; K3 192 launches a round (each of its 96 uses
    twice: the forward and remat's recompute), its backward 96, K1 none;
    losses finite; ms per round and the peak
58. the Whisper smoke model's ``make_round_step`` with frames under
    ``fedsgd`` and ``sparse_replicated``, card against host step by step
    as [53] (b); K1 once per ``sparse_replicated`` step
59. the kernel audit (``repro_torch.analysis.kernel_audit``): every
    registry entry (``kernels/introspect.py``) at its audit shapes, the
    reference's and the main paths': each launched instance's registers,
    spills (ptxas), static and dynamic shared memory, occupancy against its
    ``__launch_bounds__``, cooperative grid or cluster against what can be
    resident; the plans' coverage; K1 and K2 at two cooperative grids, K4
    at two split counts, K3 and its backward twice, bit for bit; registry
    coverage; each planted breaker failing its gate
60. PERF.md §6's bounds from ``cost_model`` (``SECTION6_BOUNDS``), and
    ``common/hw.py``'s ``HW`` against the card's properties
61. the memory contract (``analysis/hlo_audit.py``): the LR, DIN and LSTM
    sparse rounds at full width (K 100) against their budget, the
    reference's six components plus one client's working set measured at
    one and two clients; the dense-replica round against the same budget
    must trip it
62. dense intermediates (``analysis/jaxpr_audit.py``): an LR sparse round
    at MovieLens-1M width builds no float (V, ...) output; the dense
    round's are listed
63. comm drift: [33]'s counted combine bytes, every rank and step, against
    ``sparse.comm.sharded_combine_bytes`` within 10% plus 64 B
64. the sharded LLM step: Qwen2.5-14B at its widths (f32, fedsubavg, cohort
    8 x 128, remat) through ``launch.train.train`` on one device, then with
    ``mesh=`` on (1, 2) at 2 layers and 2 rounds and (2, 2) and (1, 4) at 1
    layer and 1 round, gloo ranks sharing the card (NCCL refuses two ranks on one
    device); losses and every parameter within 1e-4 of one device's, each
    leaf's update within 1e-3 in relative norm, K3 and its backward as
    often on each rank as on one device, every whole leaf the same bits on
    every model rank after each round; ms per round and each rank's peak
65. Mixtral at its widths, 1 layer, f32: the tensor-parallel baseline and
    expert parallelism on (1, 2) against one device, as [64], the routing
    identical
66. each rank's collective counters against ``tp_collective_budget`` in
    every round; a 1-rank NCCL (1, 1) mesh at the 100m scale within 1e-5 of
    one device; K3 and its backward at [64]'s per-rank shapes (m = 2: H 20,
    KV 4; m = 4: H 10, KV 2; B 8, S 128, hd 128, f32) against their plain
    versions, timed beside SDPA and the bound
67. K4's log-sum-exp instance (``flash_decode(..., return_lse=True)``) at
    the ranks' slices of Qwen2.5-14B's cache (2,064 and 1,032 of 4,128
    slots), Mixtral's ring (4,096 in 2) and slices with no valid slot,
    against its plain version, f32 and bf16; the in-process merge of 2 and
    4 slices (``merge_decode_slices``) against whole-cache K4 and the plain
    version (2e-5; 2e-2 and 1e-2 in relative norm); K3 at the ranks'
    prefill shapes of [68] (f32: Qwen2.5-14B's B 2 and 4, S 1,024, H 20 /
    KV 4 and H 10 / KV 2; Mixtral's B 2, S 4,160, H 24, KV 4, window 4,096)
    and [69] (bf16, B 4, S 4,096, H 20 / KV 4 and H 10 / KV 2) against its
    plain version, timed beside SDPA and the bound
68. sharded serving (``launch.serve.serve(mesh=...)`` under
    ``make_rules("decode")``) in f32 on gloo ranks sharing the card against
    one device: Qwen2.5-14B's widths at 2 layers, 2 x 1,024 + 16 steps on
    (1, 2) and 4 x 1,024 on (1, 4); Mixtral's at 1 layer, TP and EP on
    (1, 2), 2 x 4,160 (past the 4,096-slot window: the ring split); logits
    within 1e-4, greedy tokens identical, every rank's counters of the
    prefill and each step equal to ``serve_collective_budget``; a 1-rank
    NCCL (1, 1) mesh at the 100m scale equal to one device
69. bf16 timing at Qwen2.5-14B's widths, 8 layers, 4 x 4,096 + 32 steps, on
    one device, (1, 2) and (1, 4): prefill ms, ms per step, the serving's
    peak and the cache's bytes per rank (1/m of one device's), K3 8 a
    prefill and K4's log-sum-exp instance 8 a step on every rank; the
    prefill's and first step's logits no further from the f32 run's than
    1.25 x one bf16 device's; K4's log-sum-exp instance at the ranks'
    slices timed beside its plain version and SDPA (o alone)
70. the row-sparse transport on a vocabulary split over ``model``:
    Qwen2.5-14B at its widths, 1 layer, f32, fedsubavg, [64]'s corpus for 2
    rounds through ``train(mesh=..., sparse=True)`` on (1, 2) and (2, 2)
    against one device's sparse run: as [64] (losses and parameters 1e-4,
    updates 1e-3, whole leaves), ``sub_rows`` and the uplink bytes equal,
    counters equal to ``tp_collective_budget(sparse=True)``, K1 once a
    round on every rank (the union combine over ``data`` on the rank's
    slice of 76,032 or 38,016 rows) and never on one device; K1 at the
    (2, 2) rank's slice shape against its plain version (ids exact, rows
    2e-5), timed beside ``torch.unique`` + ``index_add_`` and its bound

[64]-[65]'s and [70]'s ranks run in one spawn of 4 gloo ranks (a (1, 2)
job on one of the world's two (1, 2) meshes, Qwen2.5's two at once),
[68]-[69]'s in another (``run_tp``); [70]'s single-device run is made in
[64], and its checks are printed after [69].

It ends with the kernels as one JSON line (K1's entry also carries its
launches on the LR, DIN and LSTM paths, on the scaffold and fedadam paths,
on the replicated and int8 paths, in ``make_round_step``, on the telemetry
runs and the async fires, per rank on the mesh and on [37]'s LLM steps,
and its times at the DIN and LSTM rounds, at an async fire and at the
mesh's partial and union combine; K3's its launches on the training path
and its times at the training shape; K3-backward's entry its launches on
[35] and its share of a round; three rows more for [40]'s K3 and K4 and
K3's backward at Mixtral's training shape; seven for [45]'s and [46]'s K3
and K4 and [44]'s three backward shapes; three for [50]'s and [53]'s; eight
for Whisper's three K3 shapes, two K4 shapes and three backward shapes;
four for K3 and its backward at [64]'s per-rank shapes, each with its
launches per rank; two for K4's log-sum-exp instance at [69]'s rank
slices and five for K3 at [67]'s rank prefill shapes, each with its
launches per rank from [68]/[69]; one for K1 at [70]'s (2, 2) rank slice,
with its launches per rank), the card line and, last,
``{"ok": true, "device": {...}}``.

"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import re
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import tracemalloc
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs.base import FedConfig  # noqa: E402
from repro_torch.federated import ArrivalSim, BufferedAsyncServerUpdate  # noqa: E402
from repro_torch.telemetry import TraceSink, read_events, telemetry_to_host  # noqa: E402
from repro_torch.data.batching import pooled_batches  # noqa: E402
from repro_torch.data.synthetic import (make_amazon_like,  # noqa: E402
                                        make_movielens_like, make_sent140_like)
from repro_torch.core.preconditioner import (condition_number,  # noqa: E402
                                             preconditioned_hessian)
from repro_torch.data.batching import sample_cohort_batch  # noqa: E402
from repro_torch.federated.plan import (CohortSharding, FedSgdLocal,  # noqa: E402
                                        RoundPlan, RowSparseTransport, ServerUpdate,
                                        SubmodelReplicatedLocal, build_round_step,
                                        resolve_plan, round_collective_budget)
from repro_torch.launch.mesh import (MESH_AXES, CohortMesh, make_cohort_mesh,  # noqa: E402
                                     make_device_mesh, spawn_ranks)
from repro_torch.launch.shardings import _index, local_part, param_specs  # noqa: E402
from repro_torch.federated.simulation import make_round_step  # noqa: E402
from repro_torch.core.algorithms import ServerState  # noqa: E402
from repro_torch.sparse import compress  # noqa: E402
from repro_torch.federated.server import FederatedTrainer  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import _build, _rows  # noqa: E402
from repro_torch.kernels.flash_attention import (FlashAttention,  # noqa: E402
                                                 FlashAttentionBackward,
                                                 bwd_cluster, flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_torch,
                                                 flash_attention_torch)
from repro_torch.data.synthetic import make_lm_federated  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_torch  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import layers as layers_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models import whisper, zamba  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.layers import cache_slot_positions  # noqa: E402
from repro_torch.kernels.heat_scatter import (rowsparse_scatter,  # noqa: E402
                                              rowsparse_scatter_torch)
from repro_torch.kernels.union_segsum import (union_segsum,  # noqa: E402
                                              union_segsum_torch)
from repro_torch.analysis import hlo_audit, kernel_audit  # noqa: E402
from repro_torch.analysis.hlo_audit import comm_drift  # noqa: E402
from repro_torch.analysis.jaxpr_audit import find_dense_intermediates  # noqa: E402
from repro_torch.analysis.kernel_audit import cost_model, roofline  # noqa: E402
from repro_torch.common.hw import HW  # noqa: E402
from repro_torch.federated import plan as plan_mod  # noqa: E402
from repro_torch.sparse import aggregate as aggregate_mod  # noqa: E402
from repro_torch.sparse.aggregate import aggregate_rowsparse_dense, pick_combine  # noqa: E402
from repro_torch.sparse.rowsparse import RowSparse, unique_ids_padded  # noqa: E402
from tools.aggregation_times import N_CLIENTS, SHAPES, cohort, cuda_ms  # noqa: E402
from tools.paper_tables import DIN_DATA, print_tables, tables, task_bindings  # noqa: E402

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}   # tests/test_kernels.py:14-15
BF16_REL_TOL = 1e-2            # ||got - want|| / ||want|| for bf16 comparisons
SEED = 0
DEV = torch.device("cuda")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def compare(name, got, want, dtype) -> float:
    """Max abs error of ``got`` against ``want``, held to ``TOL``; bf16 is
    also held to ``BF16_REL_TOL`` in relative norm, since its element bound
    is loose against small outputs."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    tol = TOL[dtype]
    check(torch.allclose(got, want, rtol=tol, atol=tol),
          f"{name}: kernel disagrees with its plain version (max abs err {err})")
    if dtype == torch.bfloat16 and got.numel():
        rel = float(torch.linalg.vector_norm((got - want).float())
                    / torch.linalg.vector_norm(want.float()).clamp(min=1e-30))
        check(rel <= BF16_REL_TOL, f"{name}: relative error {rel} > {BF16_REL_TOL}")
        print(f"    {name}: bf16 relative error {rel:.3g}")
    return err


def phase_k1(rng) -> float:
    v, k, r, _ = SHAPES["trainer"]
    hv, hk, hr, hd = SHAPES["heavy"]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("main", v, k, r, 1, dtype, {}, True, None),
                  ("wide", 262_144, 16, 2_048, 16, dtype, {}, True, None),
                  ("D=18", v, k, r, 18, dtype, {}, True, None),
                  ("D=25", v, k, r, 25, dtype, {}, True, None),
                  ("hot", v, 1000, r, 18, dtype, {"hot": 7}, True, None),
                  ("heavy", hv, hk, hr, hd, dtype, {}, True, None)]
    cases += [
        ("no-heat", v, k, r, 1, torch.float32, {}, False, None),
        ("ids>=V", v, k, r, 1, torch.float32, {"out_of_range": 0.05}, True, None),
        ("ids>=V", v, k, r, 25, torch.float32, {"out_of_range": 0.05}, True, None),
        ("all-pad", v, k, r, 1, torch.float32, {"all_pad": 10}, True, None),
        ("overflow", v, k, r, 1, torch.float32, {}, True, "half"),
        ("overflow", v, k, r, 18, torch.bfloat16, {}, True, "half"),
    ]
    worst = 0.0
    for name, vv, kk, rr, d, dtype, kw, with_heat, cap in cases:
        ids, rows, heat = cohort(rng, kk, rr, vv, d, dtype, DEV, **kw)
        heat = heat if with_heat else None
        union = int(torch.unique(ids[(ids >= 0) & (ids < vv)]).numel())
        c = union // 2 if cap == "half" else min(vv, kk * rr)
        err = check_k1(f"union_segsum[{name}]", (ids, rows, heat, float(N_CLIENTS), c, vv),
                       1.0 / kk, union)
        worst = max(worst, err)
        print(f"  K1 {name:8s} {str(dtype):14s} V={vv} T={kk * rr} D={d} cap={c} "
              f"union={union} max_abs_err={err:.3g}")
    # back to back on one V: a large union, then a small one into the same
    # capacity; each is held to its plain version after both have run
    first = cohort(rng, k, r, v, 18, torch.float32, DEV)
    second = cohort(rng, 8, 16, v, 18, torch.float32, DEV)
    cap = k * r
    outs = [union_segsum(*c, float(N_CLIENTS), cap, v, scale=0.5) for c in (first, second)]
    for i, (c, (got_ids, got_rows)) in enumerate(zip((first, second), outs)):
        want_ids, want_rows = union_segsum_torch(*c, float(N_CLIENTS), cap, v, scale=0.5)
        torch.cuda.synchronize()
        check(torch.equal(got_ids, want_ids), f"union_segsum[back-to-back {i}]: ids differ")
        err = compare(f"union_segsum[back-to-back {i}]", got_rows, want_rows, torch.float32)
        worst = max(worst, err)
        print(f"  K1 back-to-back call {i}: V={v} T={c[0].numel()} D=18 cap={cap} "
              f"union={int((want_ids >= 0).sum())} max_abs_err={err:.3g}")
    return worst


def check_k1(name, args, scale, union) -> float:
    """One K1 call against its plain version: ids exact, the union's size,
    rows within tolerance."""
    got_ids, got_rows = union_segsum(*args, scale=scale)
    want_ids, want_rows = union_segsum_torch(*args, scale=scale)
    torch.cuda.synchronize()
    check(torch.equal(got_ids, want_ids), f"{name}: ids differ")
    check(int((got_ids >= 0).sum()) == min(union, args[4]), f"{name}: union size")
    return compare(name, got_rows, want_rows, args[1].dtype)


def phase_k2(rng) -> float:
    v, k, r, _ = SHAPES["trainer"]
    hv, hk, hr, hd = SHAPES["heavy"]
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        cases += [("main", v, k, r, 1, dtype, {}),
                  ("wide", 65_536, 16, 2_048, 16, dtype, {}),
                  ("D=18", v, k, r, 18, dtype, {}),
                  ("D=25", v, k, r, 25, dtype, {}),
                  ("hot", v, 1000, r, 18, dtype, {"hot": 7}),
                  ("heavy", hv, hk, hr, hd, dtype, {})]
    cases += [("ids>=V", v, k, r, 25, torch.float32, {"out_of_range": 0.05}),
              ("all-pad", v, k, r, 18, torch.float32, {"all_pad": 10})]
    worst = 0.0
    for name, vv, kk, rr, d, dtype, kw in cases:
        ids, rows, heat = cohort(rng, kk, rr, vv, d, dtype, DEV, **kw)
        args = (ids.reshape(-1), rows.reshape(kk * rr, d), heat, float(N_CLIENTS), vv)
        got = rowsparse_scatter(*args, scale=1.0 / kk)
        want = rowsparse_scatter_torch(*args, scale=1.0 / kk)
        err = compare(f"rowsparse_scatter[{name}]", got, want, dtype)
        worst = max(worst, err)
        del got, want
        print(f"  K2 {name:8s} {str(dtype):14s} V={vv} T={kk * rr} D={d} max_abs_err={err:.3g}")
    # back to back on one V, each held to its plain version after both ran
    calls = [cohort(rng, kk, rr, v, 18, torch.float32, DEV) for kk, rr in ((k, r), (8, 16))]
    args = [(i.reshape(-1), w.reshape(i.numel(), 18), h, float(N_CLIENTS), v)
            for i, w, h in calls]
    outs = [rowsparse_scatter(*a, scale=0.5) for a in args]
    for i, (a, got) in enumerate(zip(args, outs)):
        err = compare(f"rowsparse_scatter[back-to-back {i}]", got,
                      rowsparse_scatter_torch(*a, scale=0.5), torch.float32)
        worst = max(worst, err)
        print(f"  K2 back-to-back call {i}: V={v} T={a[0].numel()} D=18 max_abs_err={err:.3g}")
    return worst


#: [15]: the DIN paper's Amazon Electronics (Zhou et al., KDD 2018, Table 1:
#: 192,403 users, 63,001 goods, 1,689,188 samples, ~9 per user): DIN_DATA
DIN_REDUCED = ("clients 192,403 -> 2,000 (the host generator loops per client over "
               "a 63,001-long distribution); goods, samples per client and widths as "
               "published")
#: [16]: the repository's Sent140-like shape (24 tokens, ~30 samples per client)
LSTM_DATA = dict(num_clients=1000, vocab=20000, seq_len=24, mean_samples=30, seed=SEED)
LSTM_REDUCED = ("none against a published size: the repository gives none for its "
                "Sent140-like data, so 1,000 clients and a 20,000-word vocabulary are "
                "this script's choice; emb 25, hidden 100, two cells as in the repository")


def make_trainer(ds, alg: str, device, plan=None, telemetry: bool = False, sink=None,
                 mesh=None, **fed_kw) -> FederatedTrainer:
    """The paper's model for the dataset's task at the repository's widths
    (``tools/paper_tables.py::task_bindings``; random leaves drawn on the
    host from ``SEED``, so the card and the host start alike), K = 100, on
    the sparse plan unless ``fed_kw`` says otherwise. Telemetry is off
    unless asked for, so that the phases timing rounds run the program
    they timed before the trainer's default turned it on."""
    cfg = FedConfig(**{**dict(num_clients=ds.num_clients, clients_per_round=100,
                              local_iters=5, local_batch=5, lr=0.5, algorithm=alg,
                              sparse=True, seed=SEED), **fed_kw})
    make_params, loss, predict = task_bindings(ds, SEED)
    return FederatedTrainer(ds, make_params, loss, cfg, predict_fn=predict, plan=plan,
                            device=device, telemetry=telemetry, sink=sink, mesh=mesh)


def drive(tr: FederatedTrainer, label: str) -> dict:
    """20 rounds: 10 through ``run_round`` (timed one by one), 10 through
    ``run`` with the multi-round engine, then the evaluation record."""
    losses, ms = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        losses.append(tr.run_round())          # reads the loss back: a sync
        ms.append((time.perf_counter() - t0) * 1e3)
    before = len(tr.history)
    tr.run(10, eval_every=10, engine=True)
    rec = tr.history[before]
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
    check(math.isfinite(rec.train_loss) and rec.train_loss < losses[0],
          f"{label}: train loss did not fall ({losses[0]} -> {rec.train_loss})")
    check(0.5 < rec.test_metric <= 1.0, f"{label}: AUC {rec.test_metric}")
    out = {"round_loss": losses, "round_ms": ms,
           "steady_ms_per_round": statistics.median(ms[2:]),
           "run_ms_per_round": rec.wall_time * 1e3,
           "train_loss": rec.train_loss, "auc": rec.test_metric,
           "capacity": tr._last_capacity,
           "comm": tr.comm_summary() if tr.comm_log else None}
    print(f"  {label}: per-round loss {[round(x, 5) for x in losses]}")
    print(f"  {label}: after 20 rounds train_loss={rec.train_loss:.5f} "
          f"auc={rec.test_metric:.5f}; ms/round run_round median "
          f"{out['steady_ms_per_round']:.2f}, run(engine) {out['run_ms_per_round']:.2f}")
    return out


@contextlib.contextmanager
def capture_k1(captured: dict):
    """Record the inputs of the aggregation's K1 calls (the last one stays)
    in ``captured``; the calls still launch K1."""
    def capture(*args, **kw):
        captured["args"], captured["kw"] = args, kw
        return union_segsum(*args, **kw)

    aggregate_mod.union_segsum = capture
    try:
        yield
    finally:
        aggregate_mod.union_segsum = union_segsum


def phase_main_path(ds) -> tuple:
    """The trainer at full width. Returns the per-run summaries, the K1
    launch count of the run and the K1 inputs of one fedsubavg round."""
    captured = {}
    union_segsum.launches = 0
    rowsparse_scatter.launches = 0
    runs = {}
    with capture_k1(captured):
        runs["fedsubavg"] = drive(make_trainer(ds, "fedsubavg", DEV), "fedsubavg")
    check(union_segsum.launches == 20, f"K1 served {union_segsum.launches}/20 rounds")
    runs["fedavg"] = drive(make_trainer(ds, "fedavg", DEV), "fedavg")
    check(union_segsum.launches == 40, f"K1 served {union_segsum.launches}/40 rounds")
    plan = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(topk=16),
                     ServerUpdate("fedsubavg"))
    runs["fedsubavg_top16"] = drive(make_trainer(ds, "fedsubavg", DEV, plan),
                                    "fedsubavg top-16")
    launches = union_segsum.launches
    check(launches == 60, f"K1 served {launches}/60 rounds")
    return runs, launches, captured


def phase_deep_path(ds) -> tuple:
    """[15] and [16]: DIN or the LSTM at the repository's widths through the
    trainer, fedsubavg then fedavg, 20 rounds each; K1 must serve every
    round once. K1 is then held to its plain version on the inputs of one
    fedsubavg round (ids exact, f32 2e-5). Returns the runs, K1's launches
    on this path, the captured inputs and K1's error on them."""
    captured = {}
    union_segsum.launches = 0
    runs = {}
    with capture_k1(captured):
        runs["fedsubavg"] = drive(make_trainer(ds, "fedsubavg", DEV), f"{ds.task} fedsubavg")
    check(union_segsum.launches == 20, f"K1 served {union_segsum.launches}/20 rounds")
    runs["fedavg"] = drive(make_trainer(ds, "fedavg", DEV), f"{ds.task} fedavg")
    launches = union_segsum.launches
    check(launches == 40, f"K1 served {launches}/40 rounds")
    print(f"  {ds.task}: AUC after 20 rounds fedsubavg {runs['fedsubavg']['auc']:.5f}, "
          f"fedavg {runs['fedavg']['auc']:.5f}; K1 {launches} launches in 40 rounds")
    args, scale = captured["args"], captured["kw"]["scale"]
    ids, rows, v = args[0], args[1], args[5]
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err = check_k1(f"union_segsum[{ds.task} round]", args, scale, union)
    print(f"  K1 at a {ds.task} fedsubavg round: V={v} T={ids.numel()} D={rows.shape[-1]} "
          f"cap={args[4]} union={union} max_abs_err={err:.3g}")
    return runs, launches, captured, err


def phase_k2_path(k1_args) -> tuple:
    """K2's own path: the dense-output cohort aggregation of the main path's
    round, against the union-then-scatter path on the host."""
    ids, rows, heat, total, cap, v = k1_args
    k = 100
    stacked = RowSparse(ids.reshape(k, -1), rows.reshape(k, ids.numel() // k, -1), v)
    rowsparse_scatter.launches = 0
    dense = aggregate_rowsparse_dense(stacked, heat, total, scale=1.0 / k)
    launches = rowsparse_scatter.launches
    check(launches == 1, f"K2 launched {launches} times on its path")
    host = aggregate_rowsparse_dense(
        RowSparse(stacked.ids.cpu(), stacked.rows.cpu(), v), heat.cpu(), total,
        scale=1.0 / k)
    err = float((dense.cpu() - host).abs().max())
    check(torch.allclose(dense.cpu(), host, rtol=2e-5, atol=2e-5),
          f"K2 path disagrees with the host path (max abs err {err})")
    print(f"  K2 path: aggregate_rowsparse_dense V={v} T={ids.numel()} "
          f"launches={launches} max_abs_err vs host={err:.3g}")
    return launches, err


def slots(state) -> tuple:
    """The optimizer's slot dicts of a ServerState (none, one or two)."""
    return (state.opt,) if isinstance(state.opt, dict) else tuple(state.opt)


def phase_card_vs_host(ds, rounds: int = 5, cases=(("fedsubavg", "fedsubavg", {}),
                                                    ("fedavg", "fedavg", {}))) -> dict:
    """``rounds`` rounds of each ``(label, algorithm, FedConfig flags)`` on
    the card and on the host: losses, parameters and optimizer slots within
    1e-5."""
    out = {}
    for label, alg, kw in cases:
        card, host = make_trainer(ds, alg, DEV, **kw), make_trainer(ds, alg, "cpu", **kw)
        lc = [card.run_round() for _ in range(rounds)]
        lh = [host.run_round() for _ in range(rounds)]
        dl = max(abs(a - b) for a, b in zip(lc, lh))
        check(np.allclose(lc, lh, rtol=1e-5, atol=1e-5),
              f"{label}: card and host losses differ by {dl}")
        dp = 0.0
        card_trees = (card.state.params,) + slots(card.state)
        host_trees = (host.state.params,) + slots(host.state)
        check(len(card_trees) == len(host_trees), f"{label}: optimizer slots differ")
        for ct, ht in zip(card_trees, host_trees):
            for name, p in ct.items():
                q = ht[name]
                dp = max(dp, float((p.cpu() - q).abs().max()))
                check(torch.allclose(p.cpu(), q, rtol=1e-5, atol=1e-5),
                      f"{label}: card and host '{name}' differ by {dp}")
        out[label] = {"max_loss_diff": dl, "max_param_diff": dp}
        print(f"  {ds.task} {label}: {rounds} rounds card vs host: max |loss diff| "
              f"{dl:.3g}, max |param or slot diff| {dp:.3g} "
              f"({len(card_trees) - 1} slot dicts)")
    return out


#: [19]: the paper's Table 2 algorithms at [4]'s configuration, with the
#: server step sizes of ``benchmarks/bench_table2.py``
PROTOCOL_RUNS = (("scaffold sparse", "scaffold", dict(sparse=True, server_lr=1.0)),
                 ("fedadam sparse", "fedadam", dict(sparse=True, server_lr=0.03)),
                 ("scaffold dense", "scaffold", dict(sparse=False, server_lr=1.0)),
                 ("fedadam dense", "fedadam", dict(sparse=False, server_lr=0.03)),
                 ("fedsubavg dense", "fedsubavg", dict(sparse=False)),
                 ("central", "central", dict(sparse=False)))


def phase_protocol_paths(ds) -> tuple:
    """[19]: each run driven as in [4] with K1's count set to 0 just before
    it and read just after: 20 launches on the sparse plan, none on the
    dense plan or central. K1 is held to its plain version on the inputs of
    one scaffold round (no heat, scale 1/K). Returns the runs, K1's launches
    by run and its error there."""
    runs, launches, captured = {}, {}, {}
    for label, alg, kw in PROTOCOL_RUNS:
        ctx = capture_k1(captured) if label == "scaffold sparse" else contextlib.nullcontext()
        union_segsum.launches = 0
        with ctx:
            runs[label] = drive(make_trainer(ds, alg, DEV, **kw), label)
        launches[label] = union_segsum.launches
        want = 20 if kw["sparse"] else 0
        check(launches[label] == want, f"{label}: K1 launched {launches[label]} times "
              f"in 20 rounds, want {want}")
    order = sorted(runs, key=lambda r: -runs[r]["auc"])
    print("  AUC after 20 rounds (a finding, not asserted): "
          + ", ".join(f"{r} {runs[r]['auc']:.5f}" for r in order))
    print("  K1 launches: " + ", ".join(f"{r} {n}" for r, n in launches.items()))
    args, scale = captured["args"], captured["kw"]["scale"]
    ids, rows, v = args[0], args[1], args[5]
    check(args[2] is None and scale == 1.0 / 100, "scaffold's K1 call: no heat, scale 1/K")
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err = check_k1("union_segsum[scaffold round]", args, scale, union)
    print(f"  K1 at a scaffold round: V={v} T={ids.numel()} D={rows.shape[-1]} "
          f"cap={args[4]} union={union} no heat max_abs_err={err:.3g}")
    for label, alg, kw in PROTOCOL_RUNS:
        if label != "scaffold dense":       # the dense plan's twin of fedadam's
            phase_profile(ds, runs[label]["steady_ms_per_round"], label=label, alg=alg,
                          **kw)
    return runs, launches, err


#: [20]: heat estimators on the sparse plan
HEAT_RUNS = (("randomized response", dict(heat_estimator="randomized_response")),
             ("randomized response, weighted", dict(heat_estimator="randomized_response",
                                                    weighted=True)),
             ("exact, weighted", dict(weighted=True)))


def phase_private_heat(ds) -> dict:
    """[20]: the heat's resolve on the host, timed, with its numpy peak
    (tracemalloc, which numpy reports to) and the process's peak resident
    memory after it (getrusage; a high-water mark of the whole run), then
    10 fedsubavg rounds on the sparse plan with that heat (K1 once per
    round, losses finite; their course and the AUC are printed)."""
    out = {}
    for label, kw in HEAT_RUNS:
        cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=100, seed=SEED, **kw)
        tracemalloc.start()
        t0 = time.perf_counter()
        heat = FederatedTrainer._resolve_heat(ds, cfg)
        resolve_s = time.perf_counter() - t0
        peak = tracemalloc.get_traced_memory()[1]
        tracemalloc.stop()
        maxrss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        union_segsum.launches = 0
        tr = make_trainer(ds, "fedsubavg", DEV, **kw)
        check(np.array_equal(tr.heat.counts, heat.counts), f"{label}: heat differs")
        losses = [tr.run_round() for _ in range(10)]
        launches = union_segsum.launches
        auc = tr.evaluate()
        check(launches == 10, f"{label}: K1 launched {launches} times in 10 rounds")
        # loss and AUC are findings here: weighted randomized response can
        # clamp a cold row's estimate to 1 against weights ~165, a factor
        # of up to W ~ 1.0M on that row's update
        check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
        out[label] = {"resolve_s": resolve_s, "numpy_peak_bytes": peak,
                      "maxrss_bytes": maxrss, "auc": auc, "losses": losses}
        print(f"  {label}: heat resolved in {resolve_s:.2f} s on the host (traced), numpy "
              f"peak {peak / 2**20:.1f} MiB, process peak RSS {maxrss / 2**30:.2f} GiB; "
              f"total {heat.total:.0f}, min {heat.counts.min():.3f}, max "
              f"{heat.counts.max():.1f}; 10 rounds loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, AUC {auc:.5f}, K1 {launches} launches")
    return out


def phase_profile(ds, steady_ms: float, n: int = 5, label: str = "fedsubavg",
                  alg: str = "fedsubavg", **fed_kw) -> dict:
    """Where one round's time goes: host sampling, device kernel time and
    launches per round (torch.profiler over ``n`` warm rounds), and the
    device's busy share of the unprofiled steady round time. K1 must be in
    a sparse round, once."""
    from torch.autograd import DeviceType

    tr = make_trainer(ds, alg, DEV, **fed_kw)
    for _ in range(3):
        tr.run_round()
    cfg = tr.cfg
    sample = (tr._sample_sparse_cohort if tr.plan is not None else
              lambda: pooled_batches(ds, cfg.local_iters,
                                     cfg.local_batch * cfg.clients_per_round, tr.np_rng))
    t0 = time.perf_counter()
    for _ in range(5):
        sample()
    sample_ms = (time.perf_counter() - t0) / 5 * 1e3
    prof, by_name, launches = device_profile(lambda: [tr.run_round() for _ in range(n)])
    device_ms = sum(by_name.values()) / n / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"host_sampling_ms_per_round": sample_ms,
           "device_kernel_ms_per_round": device_ms,
           "device_ops_per_round": launches / n,
           "steady_ms_per_round": steady_ms,
           "device_busy_share": device_ms / steady_ms if device_ms else None,
           "top_device_ops_ms_per_round": [(k[:90], v / n / 1e3) for k, v in top]}
    print(f"  {ds.task} {label} round: {steady_ms:.2f} ms steady; host sampling "
          f"{sample_ms:.2f} ms; device ops {launches / n:.0f}/round, "
          f"{device_ms:.3f} ms busy ({(out['device_busy_share'] or 0) * 100:.1f}%)")
    for name, ms in out["top_device_ops_ms_per_round"]:
        print(f"    {ms:.4f} ms/round  {name}")
    k1 = {name: us for name, us in by_name.items() if "union_segsum_kernel" in name}
    if not tr._is_sparse:
        check(not k1, f"K1 in a {label} round: {sorted(k1)}")
        return out
    check(len(k1) == 1, f"K1 in the round: {sorted(k1)}")
    # K1 launches once per round ([4], [15], [16]): its device ops per call
    # are its kernels per round
    k1_ops = sum(1 for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "union_segsum_kernel" in e.name)
    out["k1_device_ops_per_round"] = k1_ops / n
    out["k1_device_ms_per_round"] = sum(k1.values()) / n / 1e3
    print(f"    K1 in the round: {out['k1_device_ms_per_round']:.4f} ms/round in "
          f"{k1_ops / n:g} device ops  {next(iter(k1))[:90]}")
    return out


#: targets of the kernels' redesign: ms per call at the trainer's round, and
#: the least share of the bound at the heavy shape
K1_TARGET_MS, K1_TARGET_SHARE = 0.03, 0.25
K2_TARGET_MS, K2_TARGET_SHARE = 0.02, 0.50


def k1_library(flat_ids, flat_rows, heat, total, scale):
    """One PyTorch route to K1's function: ``torch.unique`` + ``index_add_``
    + the factor (the -1 pad is a union entry here; it is a yardstick only)."""
    u, inv = torch.unique(flat_ids, sorted=True, return_inverse=True)
    out = torch.zeros((u.numel(), flat_rows.shape[1]), device=DEV).index_add_(
        0, inv, flat_rows.float())
    if heat is None:
        f = torch.full(u.shape, scale, device=DEV)
    else:
        h = heat[u.clamp(min=0)]
        f = torch.where(h > 0, total / h.clamp(min=1.0), 0.0) * scale
    return u, out * torch.where(u >= 0, f, 0.0)[:, None]


def k2_library(flat_ids, flat_rows, heat, total, v, scale):
    """One PyTorch route to K2's function: ``index_add_`` + the factor."""
    keep = flat_ids >= 0
    out = torch.zeros((v, flat_rows.shape[1]), device=DEV).index_add_(
        0, flat_ids.clamp(min=0).long(), flat_rows.float() * keep[:, None])
    f = torch.where(heat > 0, total / heat.clamp(min=1.0), 0.0)
    return out * f[:, None] * scale


#: the kernels whose wrappers count their launches, by the name of their one
#: device op per launch ([6] checks that it is one)
COUNTED_KERNELS = (("union_segsum_kernel", union_segsum),
                   ("rowsparse_scatter_kernel", rowsparse_scatter))


def device_profile(fn, attempts: int = 5, calls: int = 1) -> tuple:
    """``(prof, device us by kernel name, device ops)`` of torch.profiler
    around ``fn()``, which makes ``calls`` identical calls with one kernel
    sequence each, or, with ``calls=1``, one piece of work (rounds: their
    device ops vary with the data, by a few in an LSTM round's 11,300).

    Short profiles have come back empty, or one K1 event short of five
    calls, while the launch counters showed the work ran: the first
    kernels after the profiler starts can go unrecorded. So the host waits
    50 ms inside the profile before ``fn()``, and a trace stands only if it
    holds exactly as many K1 and K2 events as their launch counters rose by
    (one device op per launch, [6]) and its device events split evenly over
    the calls. A trace that fails is the profiler's miss, not a
    measurement; if none stands after ``attempts``, the check fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        torch.cuda.synchronize()
        before = [w.launches for _, w in COUNTED_KERNELS]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            fn()
            torch.cuda.synchronize()
        by_name, ops = device_times(prof)
        counted = [(sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                        and name in e.name), w.launches - b)
                   for (name, w), b in zip(COUNTED_KERNELS, before)]
        if ops > 0 and ops % calls == 0 and all(a == b for a, b in counted):
            return prof, by_name, ops
        print(f"    (the profiler recorded {ops} device events over {calls} calls, and "
              f"K1/K2 events against launches {counted}: profiling again)")
        time.sleep(0.2)
    check(False, f"no profile stood after {attempts} attempts")


def profile_calls(fn, n: int = 5) -> tuple:
    """Device ops and device milliseconds per call of ``fn``, and the device
    ops' names (torch.profiler over ``n`` warm calls)."""
    fn()
    _, by_name, ops = device_profile(lambda: [fn() for _ in range(n)], calls=n)
    return ops / n, sum(by_name.values()) / n / 1e3, sorted(by_name)


def time_k1_k2(k1_args, scale: float, label: str, keys=("k1", "k2"),
               profiled=None, profile: bool = True) -> dict:
    """K1 and K2 on one cohort: kernel, plain version and library call by
    CUDA events in turns (plain / kernel / kernel / plain), the bound, and
    device ops and device time per call from the profiler. ``profiled``
    gives those two by key where a round's profile has measured them
    already (a short profile right after a round's was seen to record no
    device events); ``profile=False`` leaves them out (not measured)."""
    ids, rows, heat, total, cap, v = k1_args
    flat_ids, flat_rows = ids.reshape(-1), rows.reshape(ids.numel(), -1)
    t, d = flat_rows.shape
    n_union = int(torch.unique(flat_ids[(flat_ids >= 0) & (flat_ids < v)]).numel())
    fns = {
        "k1": (lambda: union_segsum(*k1_args, scale=scale),
               lambda: union_segsum_torch(*k1_args, scale=scale),
               lambda: k1_library(flat_ids, flat_rows, heat, total, scale)),
        "k2": (lambda: rowsparse_scatter(flat_ids, flat_rows, heat, total, v, scale=scale),
               lambda: rowsparse_scatter_torch(flat_ids, flat_rows, heat, total, v,
                                               scale=scale),
               lambda: k2_library(flat_ids, flat_rows, heat, total, v, scale)),
    }
    # least bytes and operations of each function (cost_model)
    costs = {"k1": cost_model("union_segsum", t=t, d=d, cap=cap, n_union=n_union,
                              dtype=flat_rows.dtype, heat=heat is not None),
             "k2": cost_model("rowsparse_scatter", t=t, d=d, v=v, n_union=n_union,
                              dtype=flat_rows.dtype)}
    out = {"shape": f"V={v} T={t} D={d} cap={cap} union={n_union} "
                    f"{str(flat_rows.dtype).replace('torch.', '')}"}
    for key in keys:
        kernel, plain, library = fns[key]
        p1, m1, m2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
        lib = cuda_ms(library)
        if not profile:
            ops, dev_ms, names = None, None, []
        elif profiled is None:
            ops, dev_ms, names = profile_calls(kernel)
        else:
            (ops, dev_ms), names = profiled[key], ["from the round's profile"]
        b, by = costs[key].bound_ms, costs[key].bound_by
        out[key] = {"ms": min(m1, m2), "plain_ms": min(p1, p2), "library_ms": lib,
                    "bound_ms": b, "bound_by": by, "share": b / min(m1, m2),
                    "device_ops_per_call": ops, "device_ms_per_call": dev_ms}
        prof = (f"profiler: {ops:g} device ops, {dev_ms:.4f} ms of device time per call "
                f"({', '.join(names)[:120]})" if profile else "not profiled")
        print(f"  {key.upper()} {label} {out['shape']}: kernel {m1:.4f}/{m2:.4f} ms "
              f"({b / min(m1, m2) * 100:.1f}% of the bound), plain {p1:.4f}/{p2:.4f} ms, "
              f"library {lib:.4f} ms, bound {b:.5f} ms ({by}); {prof}")
        check(not profile or ops == 1,
              f"{key.upper()} {label}: {ops} device ops per call, want one")
    return out


def k1_scratch_bytes(k1_args, scale: float) -> tuple:
    """Device bytes one K1 call requests beyond its two outputs (the peak of
    the caching allocator's requested bytes, which a reused cached block
    does not inflate; out_ids and the scratch share one allocation, with
    up to 4 bytes of alignment between them), the launch plan, and the
    scratch the cost model prices for that plan."""
    ids, rows, heat, total, cap, v = k1_args
    flat_rows = rows.reshape(ids.numel(), -1)
    t, d = flat_rows.shape
    bf16 = rows.dtype == torch.bfloat16
    vec = _rows.vector_width(d, flat_rows.data_ptr(), flat_rows.element_size())
    plan = _rows.union_plan(t, d, v, cap, vec, _rows.max_blocks("union_segsum", DEV, bf16, vec))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_stats()["requested_bytes.all.current"]
    out_ids, out_rows = union_segsum(*k1_args, scale=scale)
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    scratch = cost_model("union_segsum", t=t, d=d, cap=cap, n_union=0, num_rows=v,
                         blocks=plan.blocks).extra["scratch_bytes"]
    return peak - base - 4 * out_ids.numel() - 4 * out_rows.numel(), plan, scratch


def phase_timing(k1_args, launches_k1: int, launches_k2: int, err_k1: float,
                 err_k2: float, rng) -> list:
    ids, rows, heat, total, cap, v = k1_args
    k = 100
    # the main path's own round, kernel against plain version once more
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err_k1 = max(err_k1, check_k1("union_segsum[trainer round]", k1_args, 1.0 / k, union))
    res = {"trainer": time_k1_k2(k1_args, 1.0 / k, "trainer round")}
    hv, hk, hr, hd = SHAPES["heavy"]
    for dtype in (torch.float32, torch.bfloat16):
        hids, hrows, hheat = cohort(rng, hk, hr, hv, hd, dtype, DEV)
        args = (hids, hrows, hheat, float(N_CLIENTS), min(hv, hk * hr), hv)
        res[str(dtype)] = time_k1_k2(args, 1.0 / hk, "heavy")
        extra, plan, scratch = k1_scratch_bytes(args, 1.0 / hk)
        print(f"  K1 heavy {dtype}: {extra} bytes requested beyond the outputs (plan "
              f"{scratch}: {plan.words} words and {plan.blocks} blocks; V/4 = "
              f"{hv / 4:.0f}, a V-sized int32 array {4 * hv})")
        check(extra <= scratch + 4, f"K1 heavy: {extra} bytes of scratch")
        del hids, hrows, hheat, args
    tr, hf, hb = res["trainer"], res[str(torch.float32)], res[str(torch.bfloat16)]
    for key, ms_target, share_target in (("k1", K1_TARGET_MS, K1_TARGET_SHARE),
                                         ("k2", K2_TARGET_MS, K2_TARGET_SHARE)):
        met = lambda ok: "met" if ok else "missed"  # noqa: E731
        print(f"  {key.upper()} targets: trainer round {tr[key]['ms']:.4f} ms vs "
              f"<= {ms_target} ms: {met(tr[key]['ms'] <= ms_target)}; heavy f32 "
              f"{hf[key]['share'] * 100:.1f}% / bf16 {hb[key]['share'] * 100:.1f}% of "
              f"the bound vs >= {share_target * 100:.0f}%: "
              f"{met(min(hf[key]['share'], hb[key]['share']) >= share_target)}")

    def entry(key, name, source, replaces, launches, err):
        heavy = {"shape": hf["shape"].rsplit(" ", 1)[0]}
        for tag, r in (("f32", hf), ("bf16", hb)):
            heavy[tag] = {f: r[key][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "device_ops_per_call")}
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": tr[key]["ms"],
                "plain_ms": tr[key]["plain_ms"], "bound_ms": tr[key]["bound_ms"],
                "bound_by": tr[key]["bound_by"], "library_ms": tr[key]["library_ms"],
                "device_ops_per_call": tr[key]["device_ops_per_call"], "heavy": heavy}

    return [entry("k1", "union_segsum", "src/repro_torch/kernels/csrc/union_segsum.cu",
                  "src/repro/kernels/union_segsum.py:170", launches_k1, err_k1),
            entry("k2", "rowsparse_scatter",
                  "src/repro_torch/kernels/csrc/rowsparse_scatter.cu",
                  "src/repro/kernels/heat_scatter.py:138", launches_k2, err_k2)]


# ---------------------------------------------------------------------------
# The serving path: K3, K4 and Qwen2.5-14B
# ---------------------------------------------------------------------------

SERVE_ARCH = "qwen2_5_14b"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1024, 32
HOST_PROMPT, HOST_GEN, HOST_TOL = 256, 8, 1e-4
K3_TARGET_MS = 0.25            # bf16 K3 at the serving prefill, per launch
K4_SPLIT_TARGET_US = 19.0      # K4's split pass inside the decode step, per launch


def normal(rng, shape, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(DEV, dtype)


def phase_k3(rng) -> float:
    """K3 against its plain version, case by case (tolerance by dtype). The
    bf16 cases run the wgmma kernel, the f32 ones the 3xTF32 mma.sync one;
    every case runs in both."""
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("prefill", 4, 1024, 1024, 40, 8, 128, True, 0, 0, bf),
             ("prefill", 4, 1024, 1024, 40, 8, 128, True, 0, 0, f32),
             ("window", 2, 1024, 1024, 40, 8, 128, True, 300, 0, bf),
             ("window", 2, 1024, 1024, 40, 8, 128, True, 300, 0, f32),
             ("hd16", 2, 512, 512, 16, 4, 16, True, 0, 0, bf),
             ("hd16", 2, 512, 512, 16, 4, 16, True, 0, 0, f32),
             ("hd32", 2, 512, 512, 16, 4, 32, True, 0, 0, bf),
             ("hd32", 2, 512, 512, 16, 4, 32, True, 0, 0, f32),
             ("hd64", 2, 512, 512, 16, 4, 64, True, 0, 0, bf),
             ("mha-hd64", 2, 512, 512, 16, 16, 64, True, 0, 0, f32),
             ("non-causal", 1, 512, 512, 40, 8, 128, False, 0, 0, bf),
             ("non-causal", 1, 512, 512, 40, 8, 128, False, 0, 0, f32),
             ("ragged", 2, 1000, 1000, 40, 8, 128, True, 0, 0, bf),
             ("ragged", 1, 200, 333, 8, 2, 128, False, 0, 0, f32),
             ("continue", 2, 200, 333, 8, 2, 128, True, 0, 133, bf),
             ("continue", 2, 200, 333, 8, 2, 128, True, 0, 133, f32),
             ("window-in", 2, 512, 512, 8, 2, 128, True, 70, 0, bf),
             ("window-in", 2, 512, 512, 8, 2, 128, True, 70, 0, f32)]
    worst = 0.0
    for name, b, sq, sk, h, kv, hd, causal, window, off, dtype in cases:
        q, k, v = (normal(rng, (b, sq, h, hd), dtype), normal(rng, (b, sk, kv, hd), dtype),
                   normal(rng, (b, sk, kv, hd), dtype))
        kw = dict(causal=causal, window=window, q_offset=off)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_torch(q, k, v, **kw)
        err = compare(f"flash_attention[{name}]", got.float(), want.float(), dtype)
        worst = max(worst, err)
        print(f"  K3 {name:10s} {str(dtype):14s} B={b} Sq={sq} Sk={sk} H={h} KV={kv} "
              f"hd={hd} causal={causal} window={window} q_offset={off} "
              f"max_abs_err={err:.3g}")
    return worst


def phase_k4(rng) -> float:
    """K4 against its plain version: full, part-filled and ring caches."""
    b, h, kv, hd = 4, 40, 8, 128
    s = SERVE_PROMPT + SERVE_GEN
    full = cache_slot_positions(s, s, False, DEV)
    part = cache_slot_positions(700, s, False, DEV)
    ring = cache_slot_positions(1300, 512, True, DEV)
    cases = [("decode", s, full, s - 1, 0, torch.bfloat16),
             ("decode", s, full, s - 1, 0, torch.float32),
             ("part-filled", s, part, 699, 0, torch.bfloat16),
             ("part-filled", s, part, 699, 0, torch.float32),
             ("ring", 512, ring, 1299, 512, torch.bfloat16),
             ("ring", 512, ring, 1299, 512, torch.float32),
             ("ring-window", 512, ring, 1299, 200, torch.float32),
             # every position above q_position: no valid slot, the mean of V
             ("empty", s, full, -5, 0, torch.bfloat16),
             ("empty", s, full, -5, 0, torch.float32)]
    worst = 0.0
    for name, slots, kpos, qpos, window, dtype in cases:
        q = normal(rng, (b, h, hd), dtype)
        kc, vc = normal(rng, (b, kv, slots, hd), dtype), normal(rng, (b, kv, slots, hd), dtype)
        got = flash_decode(q, kc, vc, kpos, qpos, window=window)
        want = flash_decode_torch(q, kc, vc, kpos, qpos, window=window)
        err = compare(f"flash_decode[{name}]", got.float(), want.float(), dtype)
        worst = max(worst, err)
        print(f"  K4 {name:11s} {str(dtype):14s} B={b} H={h} KV={kv} S={slots} hd={hd} "
              f"q_position={qpos} window={window} "
              f"valid={int(((kpos >= 0) & (kpos <= qpos)).sum())} "
              f"max_abs_err={err:.3g}")
    return worst


def capture_attention_inputs(cfg, params, batch: int = SERVE_BATCH,
                             prompt: int = SERVE_PROMPT, gen: int = SERVE_GEN,
                             **serve_kw) -> dict:
    """One K3 (first prefill layer) and one K4 (last layer of the last
    decode step) input set, recorded, as copies, in an untimed run of the
    same request as the timed one's (same weights and prompt seed). The kernels are
    reached through ``FlashAttention.forward`` for K3 and ``layers``' name
    for K4, which this run wraps. Serving runs without grad mode, so K3 must
    be asked for no log-sum-exp."""
    captured = {}
    copy = lambda args: tuple(a.clone() if torch.is_tensor(a) else a for a in args)  # noqa: E731
    k3_forward = FlashAttention.forward

    def capture_k3(q, k, v, causal, window, q_offset, query_chunk, kv_chunk, need_lse=True):
        check(not need_lse, "serving asked K3 for its log-sum-exp")
        captured.setdefault("k3", (copy((q, k, v)), dict(
            causal=causal, window=window, q_offset=q_offset, query_chunk=query_chunk,
            kv_chunk=kv_chunk)))
        return k3_forward(q, k, v, causal, window, q_offset, query_chunk, kv_chunk, need_lse)

    def capture_k4(*args, **kw):
        captured["k4"] = (copy(args), kw)
        return flash_decode(*args, **kw)

    FlashAttention.forward, layers_mod.flash_decode = staticmethod(capture_k3), capture_k4
    try:
        serve_mod.serve(cfg, batch=batch, prompt=prompt, gen=gen, device=DEV, seed=SEED,
                        params=params, **serve_kw)
    finally:
        FlashAttention.forward, layers_mod.flash_decode = staticmethod(k3_forward), flash_decode
    return captured


def phase_serve() -> tuple:
    """Qwen2.5-14B at its published size through ``launch.serve``. Returns
    the run's summary, its parameters, and one K3 and one K4 input set of
    the same request (``capture_attention_inputs``)."""
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    # one warm-up request at the same shapes (cuBLAS handles, lazy module
    # loading), so that the timed request is a steady one
    serve_mod.serve(cfg, batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=2, device=DEV,
                    seed=SEED, params=params)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_decode.launches = 0
    res = serve_mod.serve(cfg, batch=SERVE_BATCH, prompt=SERVE_PROMPT, gen=SERVE_GEN,
                          device=DEV, seed=SEED, params=params)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    nl = cfg.num_layers
    check(res.launches_prefill == {"flash_attention": nl, "flash_decode": 0, "flash_decode_lse": 0},
          f"prefill launches {res.launches_prefill}, want {nl} of K3 and none of K4")
    check(res.launches_decode == {"flash_attention": 0, "flash_decode": nl * SERVE_GEN,
                                  "flash_decode_lse": 0},
          f"decode launches {res.launches_decode}, want {nl} of K4 per step")
    check(launches == {"flash_attention": nl, "flash_decode": nl * SERVE_GEN},
          f"serving run launches {launches}")
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits), "non-finite logits")
    check(all(lg.shape == (SERVE_BATCH, cfg.vocab_size) for lg in res.logits),
          "logits shape")
    out = {"params": n_params, "init_s": init_s, "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token, "tok_per_s": res.tok_per_s,
           "peak_gb": peak / 1e9, "launches": launches}
    print(f"  {cfg.name}: {nl} layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"params ({cfg.dtype}), random init from seed {SEED} in {init_s:.1f} s")
    print(f"  prefill {SERVE_BATCH} x {SERVE_PROMPT}: {res.prefill_ms:.1f} ms; decode "
          f"{SERVE_GEN} steps: {res.decode_ms_per_token:.2f} ms/token, "
          f"{res.tok_per_s:.1f} tok/s; peak memory {peak / 1e9:.2f} GB")
    print(f"  launches: prefill {res.launches_prefill}, decode {res.launches_decode}")
    print(f"  card: {card_line()}")
    print(f"  greedy tokens of sequence 0: {res.tokens[0][:16].tolist()}")
    return out, params, capture_attention_inputs(cfg, params)


def phase_serve_card_vs_host() -> dict:
    """The serving path at full width, 2 layers, f32, on the card and on
    the host from the same weights: logits within HOST_TOL, same tokens."""
    cfg = get_config(SERVE_ARCH).replace(num_layers=2, dtype="float32")
    card = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    host = transformer.make_params(cfg, device="cpu",
                                   state={k: v.cpu() for k, v in card.state_dict().items()})
    kw = dict(batch=1, prompt=HOST_PROMPT, gen=HOST_GEN, seed=SEED)
    rc = serve_mod.serve(cfg, device=DEV, params=card, **kw)
    t0 = time.perf_counter()
    rh = serve_mod.serve(cfg, device="cpu", params=host, **kw)
    host_s = time.perf_counter() - t0
    check(rc.launches_prefill["flash_attention"] == cfg.num_layers, "card run missed K3")
    check(rh.launches_prefill["flash_attention"] == 0, "host run launched a kernel")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(rc.logits, rh.logits))
    check(all(torch.allclose(a.cpu(), b, rtol=HOST_TOL, atol=HOST_TOL)
              for a, b in zip(rc.logits, rh.logits)),
          f"card and host logits differ by {err}")
    check(torch.equal(rc.tokens.cpu(), rh.tokens), "card and host greedy tokens differ")
    print(f"  2 layers x d_model {cfg.d_model} f32, prompt {HOST_PROMPT}, {HOST_GEN} steps: "
          f"max |logit diff| {err:.3g} (tolerance {HOST_TOL}); tokens identical "
          f"{rc.tokens[0].tolist()}; host run {host_s:.1f} s")
    del card, host
    return {"max_logit_diff": err}


def sdpa_backend(fn, attempts: int = 3, calls: int = 10) -> str:
    """Which of ``scaled_dot_product_attention``'s backends ``fn`` took,
    read from the names of the device kernels of ``calls`` profiled calls
    (the host's CUDA API events name none). The profiler can miss the
    first kernels after it starts, which are all of a single call's, so
    the calls are several and a profile that caught no device kernel is
    taken again, as ``device_profile`` does."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = " ".join(e.name.lower() for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        if names:
            break
    else:
        return "not read (no profile caught a device kernel)"
    for backend, words in (("cuDNN", ("cudnn",)), ("flash", ("flash",)),
                           ("efficient attention", ("fmha", "cutlass", "efficient"))):
        if any(w in names for w in words):
            return backend
    return "math (matmuls and softmax)"


def attention_timing(captured, launches: dict, err_k3: float, err_k4: float,
                     names=("flash_attention", "flash_decode"), want_window: int = 0,
                     k3_target_ms: float | None = K3_TARGET_MS) -> list:
    """K3 and K4 at a serving path's own inputs: kernel, plain version,
    ``scaled_dot_product_attention`` on the same inputs (laid out and GQA
    heads repeated outside the timed call; causal by its flag without a
    window, by an explicit mask with one) and the bound over the valid
    (query, key) pairs."""
    import torch.nn.functional as F

    (q, k, v), kw3 = captured["k3"]
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    window, w4 = kw3.get("window", 0), captured["k4"][1].get("window", 0)
    check(window == want_window and w4 == want_window,
          f"the serving model's window is {window}, want {want_window}")
    want = flash_attention_torch(q, k, v, **kw3)
    err_k3 = max(err_k3, compare(f"{names[0]}[serving prefill]",
                                 flash_attention(q, k, v, **kw3).float(), want.float(),
                                 q.dtype))
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    qpos, kpos3 = torch.arange(sq, device=DEV)[:, None], torch.arange(sk, device=DEV)[None]
    valid3 = kpos3 <= qpos
    if window:
        valid3 &= kpos3 > qpos - window
        k3_lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid3)  # noqa: E731
    else:
        k3_lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    pairs3 = int(valid3.sum())
    k3 = lambda: flash_attention(q, k, v, **kw3)                       # noqa: E731
    k3_plain = lambda: flash_attention_torch(q, k, v, **kw3)           # noqa: E731
    p1, m1, m2, p2 = (cuda_ms(k3_plain, 5, 1), cuda_ms(k3, 20), cuda_ms(k3, 20),
                      cuda_ms(k3_plain, 5, 1))
    lib3 = cuda_ms(k3_lib, 20)
    backend3 = sdpa_backend(k3_lib)
    c3 = cost_model("flash_attention", b=b, sq=sq, h=h, kv=kvh, hd=hd, keys=sk, pairs=pairs3,
                    dtype=q.dtype)
    ops3, b3, by3 = c3.flops, c3.bound_ms, c3.bound_by

    (q4, kc, vc, kpos, qpos4), kw4 = captured["k4"]
    valid = (kpos >= 0) & (kpos <= qpos4)
    if w4:
        valid &= kpos > qpos4 - w4
    n_valid = int(valid.sum())
    err_k4 = max(err_k4, compare(f"{names[1]}[serving step]",
                                 flash_decode(q4, kc, vc, kpos, qpos4, **kw4).float(),
                                 flash_decode_torch(q4, kc, vc, kpos, qpos4, **kw4).float(),
                                 q4.dtype))
    g = q4.shape[1] // kc.shape[1]
    q4t = q4[:, :, None]
    kct, vct = kc.repeat_interleave(g, dim=1), vc.repeat_interleave(g, dim=1)
    mask = valid[None, None, None]
    k4 = lambda: flash_decode(q4, kc, vc, kpos, qpos4, **kw4)          # noqa: E731
    k4_plain = lambda: flash_decode_torch(q4, kc, vc, kpos, qpos4, **kw4)  # noqa: E731
    k4_lib = lambda: F.scaled_dot_product_attention(q4t, kct, vct, attn_mask=mask)  # noqa: E731
    o1, n1, n2, o2 = cuda_ms(k4_plain), cuda_ms(k4), cuda_ms(k4), cuda_ms(k4_plain)
    lib4 = cuda_ms(k4_lib)
    backend4 = sdpa_backend(k4_lib)
    hk = kc.shape[1]
    c4 = cost_model("flash_decode", b=q4.shape[0], h=q4.shape[1], kv=hk, hd=hd,
                    n_valid=n_valid, slots=kpos.numel(), dtype=q4.dtype)
    bytes4, b4, by4 = c4.bytes, c4.bound_ms, c4.bound_by
    ms3, ms4 = min(m1, m2), min(n1, n2)
    print(f"  K3 {names[0]} B={b} S={sq} H={h} KV={kvh} hd={hd} {q.dtype} causal window="
          f"{window} ({pairs3} valid pairs per (b, h)): kernel {m1:.4f}/{m2:.4f} ms "
          f"({ops3 / ms3 / 1e9:.1f} TFLOP/s), plain {p1:.4f}/{p2:.4f} ms, SDPA {lib3:.4f} ms "
          f"({backend3}; {ops3 / lib3 / 1e9:.1f} TFLOP/s), bound {b3:.5f} ms ({by3}; "
          f"{c3.peak / 1e12:.0f} TFLOP/s)")
    print(f"  K4 {names[1]} B={q4.shape[0]} H={q4.shape[1]} KV={hk} S={kc.shape[2]} "
          f"valid={n_valid} window={w4} {q4.dtype}: kernel {n1:.4f}/"
          f"{n2:.4f} ms ({bytes4 / ms4 / 1e9:.2f} TB/s), plain {o1:.4f}/{o2:.4f} ms, SDPA "
          f"{lib4:.4f} ms ({backend4}; {bytes4 / lib4 / 1e9:.2f} TB/s), bound {b4:.5f} ms "
          f"({by4}; {HW['hbm_bandwidth'] / 1e12:.2f} TB/s)")
    if k3_target_ms is not None:
        check(ms3 <= k3_target_ms, f"K3 at the serving prefill: {ms3:.4f} ms > the "
              f"{k3_target_ms} ms target")
    return [
        {"name": names[0], "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:100",
         "launches": launches["flash_attention"], "max_abs_err": err_k3,
         "ms": min(m1, m2), "plain_ms": min(p1, p2), "bound_ms": b3,
         "bound_by": by3, "library_ms": lib3, "library": f"SDPA, {backend3}"},
        {"name": names[1], "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode.py:88",
         "launches": launches["flash_decode"], "max_abs_err": err_k4,
         "ms": min(n1, n2), "plain_ms": min(o1, o2), "bound_ms": b4,
         "bound_by": by4, "library_ms": lib4, "library": f"SDPA, {backend4}"},
    ]


def phase_decode_profile(params, steady_ms: float, cfg=None, batch: int = SERVE_BATCH,
                         prompt: int = SERVE_PROMPT, gen: int = SERVE_GEN, n: int = 5,
                         read_bytes: float | None = None,
                         split_target_us: float | None = K4_SPLIT_TARGET_US,
                         label: str = "[10]", inputs: dict | None = None,
                         k4_per_step: int | None = None) -> dict:
    """Where one decode step's time goes at a serving shape (by default
    [10]'s): device time by op over ``n`` warm steps after a prefill of the
    same request (torch.profiler) against the unprofiled step and the
    bound of reading ``read_bytes`` (by default every weight). ``inputs``:
    the prefill's patch embeddings and M-RoPE streams, which the steps
    continue. ``k4_per_step``: K4's launches a step (by default one a
    layer)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cfg or get_config(SERVE_ARCH)
    api = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=torch.Generator().manual_seed(SEED + 1),
                         dtype=torch.int32).to(DEV)
    cache = api.init_cache(batch, prompt + gen, DEV)
    inputs = inputs or {}
    logits, cache = api.prefill(params, {"tokens": toks, **inputs}, cache)
    steps = (serve_mod.decode_mrope_pos(inputs["mrope_pos"], 3 + n)
             if "mrope_pos" in inputs else None)

    def step_batch(i):
        out = {"tokens": logits.argmax(-1).int()}
        if steps is not None:
            out["mrope_pos"] = steps[i]
        return out

    for i in range(3):
        logits, cache = api.decode_step(params, cache, step_batch(i))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            logits, cache = api.decode_step(params, cache, step_batch(3 + i))
        torch.cuda.synchronize()
    by_name, ops = device_times(prof)
    device_ms = sum(by_name.values()) / n / 1e3
    split_us = [t for name, t in by_name.items() if "split_kernel" in name]
    k4_ms = sum(t for name, t in by_name.items() if "split_kernel" in name
                or "merge_kernel" in name) / n / 1e3
    per_step = cfg.num_layers if k4_per_step is None else k4_per_step
    split_us_per_launch = sum(split_us) / (n * per_step) if per_step else 0.0
    gemm_ms = matmul_us(by_name) / n / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if read_bytes is None:
        read_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    out = {"steady_ms_per_step": steady_ms, "device_ms_per_step": device_ms,
           "device_ops_per_step": ops / n, "k4_ms_per_step": k4_ms,
           "k4_split_us_per_launch": split_us_per_launch,
           "matmul_ms_per_step": gemm_ms,
           "busy_share": device_ms / steady_ms if steady_ms else None,
           "weight_read_bound_ms": roofline(read_bytes, 0)[0]}
    print(f"  decode step: {steady_ms:.2f} ms steady (host clock, {label}); device busy "
          f"{device_ms:.3f} ms ({device_ms / steady_ms * 100:.1f}%), {ops / n:.0f} device "
          f"ops per step; matmuls {gemm_ms:.3f} ms, K4 {k4_ms:.4f} ms (split pass "
          f"{split_us_per_launch:.2f} us per launch); weight-read bound "
          f"{out['weight_read_bound_ms']:.3f} ms ({read_bytes / 1e9:.2f} GB)")
    for name, t in top:
        print(f"    {t / n / 1e3:.4f} ms/step  {name[:90]}")
    if split_target_us is not None:
        check(split_us_per_launch <= split_target_us, f"K4's split pass in the decode "
              f"step: {split_us_per_launch:.2f} us > the {split_target_us} us target")
    return out


def device_times(prof) -> tuple:
    """Device microseconds by kernel name, and the number of device ops, of
    a torch.profiler run."""
    from torch.autograd import DeviceType

    by_name, ops = {}, 0
    for e in prof.events():
        # a record_function range has a device-side span too: not an op
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.name.startswith("async_engine.")):
            ops += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return by_name, ops


def matmul_us(by_name: dict) -> float:
    # cuBLAS's kernels: nvjet_* on Hopper, *gemm*/*gemv* elsewhere
    return sum(t for name, t in by_name.items()
               if any(w in name.lower() for w in ("nvjet", "gemm", "gemv")))


def phase_prefill_profile(params, prefill_ms: float, cfg=None, batch: int = SERVE_BATCH,
                          prompt: int = SERVE_PROMPT, inputs: dict | None = None,
                          label: str = "[10]", k3_launches: int | None = None) -> dict:
    """Where one prefill's time goes at a serving shape (by default [10]'s):
    device time by op over one warm prefill of ``batch`` x ``prompt`` tokens
    (and ``inputs``' patches and streams; torch.profiler), K3's total over
    its launches, the matmuls', against the unprofiled prefill."""
    from torch.profiler import ProfilerActivity, profile

    cfg = cfg or get_config(SERVE_ARCH)
    api = build_model(cfg)
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=torch.Generator().manual_seed(SEED + 2),
                         dtype=torch.int32).to(DEV)
    req = {"tokens": toks, **(inputs or {})}
    cache = api.init_cache(batch, prompt + SERVE_GEN, DEV)
    api.prefill(params, req, cache)       # warm
    cache = api.init_cache(batch, prompt + SERVE_GEN, DEV)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        api.prefill(params, req, cache)
        torch.cuda.synchronize()
    by_name, ops = device_times(prof)
    device_ms = sum(by_name.values()) / 1e3
    k3 = [t for name, t in by_name.items() if "attention_kernel" in name]
    k3_ms = sum(k3) / 1e3
    n3 = cfg.num_layers if k3_launches is None else k3_launches
    gemm_ms = matmul_us(by_name) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    out = {"prefill_ms": prefill_ms, "device_ms": device_ms, "device_ops": ops,
           "k3_ms": k3_ms, "k3_ms_per_launch": k3_ms / n3,
           "matmul_ms": gemm_ms, "other_ms": device_ms - k3_ms - gemm_ms,
           "busy_share": device_ms / prefill_ms if prefill_ms else None}
    print(f"  prefill {batch} x {prompt}: {prefill_ms:.1f} ms (host clock, {label}); "
          f"device busy {device_ms:.2f} ms ({device_ms / prefill_ms * 100:.1f}%), {ops} "
          f"device ops; matmuls {gemm_ms:.2f} ms, K3 {k3_ms:.3f} ms "
          f"({k3_ms / n3 * 1e3:.1f} us x {n3}), the rest "
          f"{out['other_ms']:.2f} ms")
    for name, t in top:
        print(f"    {t / 1e3:.4f} ms  {name[:90]}")
    return out


def phase_replicated(ds, submodel_runs) -> tuple:
    """[23]: the replicated plan through the trainer, fedsubavg and fedavg,
    each driven as in [4] with K1's count set to 0 just before it and read
    just after (20 of 20). Its deltas on the touched rows are the submodel
    plan's, so its losses are [4]'s but for the atomics' sum order in K1.
    Returns the runs, K1's launches by run and K1's error on one round."""
    runs, launches, captured = {}, {}, {}
    for alg in ("fedsubavg", "fedavg"):
        ctx = capture_k1(captured) if alg == "fedsubavg" else contextlib.nullcontext()
        union_segsum.launches = 0
        with ctx:
            runs[alg] = drive(make_trainer(ds, alg, DEV, sparse_local="replicated"),
                              f"{alg} replicated")
        launches[alg] = union_segsum.launches
        check(launches[alg] == 20, f"{alg} replicated: K1 served {launches[alg]}/20 rounds")
        mine = runs[alg]["round_loss"] + [runs[alg]["train_loss"]]
        theirs = submodel_runs[alg]["round_loss"] + [submodel_runs[alg]["train_loss"]]
        diff = max(abs(a - b) for a, b in zip(mine, theirs))
        print(f"  {alg}: replicated against [4]'s submodel replicas, 10 round losses and "
              f"the train loss after 20: max |diff| {diff:.3g}; AUC "
              f"{runs[alg]['auc']:.5f} against {submodel_runs[alg]['auc']:.5f}")
        check(diff <= 1e-4, f"{alg}: replicated and submodel losses differ by {diff}")
    args, scale = captured["args"], captured["kw"]["scale"]
    ids, rows, v = args[0], args[1], args[5]
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err = check_k1("union_segsum[replicated round]", args, scale, union)
    print(f"  K1 at a replicated fedsubavg round: V={v} T={ids.numel()} D={rows.shape[-1]} "
          f"cap={args[4]} union={union} max_abs_err={err:.3g}")
    phase_profile(ds, runs["fedsubavg"]["steady_ms_per_round"],
                  label="fedsubavg replicated", sparse_local="replicated")
    return runs, launches, err


#: [24]: int8 rows on both replica plans, with and without top-16
INT8_RUNS = (("int8", {}), ("int8 top-16", dict(sparse_topk=16)),
             ("int8 replicated", dict(sparse_local="replicated")),
             ("int8 top-16 replicated", dict(sparse_topk=16, sparse_local="replicated")))


def int8_unbiased(rng, draws: int = 256) -> tuple:
    """Unbiased rounding on the card: ``draws`` quantisations of one cohort's
    rows (16 clients x 64 rows x D = 25, magnitudes over four decades) with
    the port's own stream, dequantised and averaged. The rounding's variance
    is ``s^2 p (1 - p) / draws`` per element, ``p`` the fractional part of
    ``x / s``. Returns the z of the grand mean (every element's deviation
    summed, over the summed standard error) and the largest z of one row's
    summed deviation. (One element's z is no test: at p ~ 1e-5 a single
    round-up in 256 draws is z ~ 20.)"""
    k, r, d = 16, 64, 25
    ids = torch.arange(r, dtype=torch.int32, device=DEV).repeat(k, 1)
    rows = normal(rng, (k, r, d), torch.float32) * torch.from_numpy(
        10.0 ** rng.uniform(-3, 1, (k, r, 1)).astype(np.float32)).to(DEV)
    rs = RowSparse(ids, rows, r)
    total = torch.zeros_like(rows)
    for i in range(draws):
        total += compress.dequantize_rows(compress.quantize_rows_int8(rs, (SEED, i, 0))).rows
    mean = total / draws
    scales = rows.abs().amax(-1, keepdim=True) / 127.0
    frac = rows / scales - torch.floor(rows / scales)
    se = scales * torch.sqrt(frac * (1 - frac) / draws)
    dev, var = mean - rows, se * se
    grand = float(dev.sum() / torch.sqrt(var.sum()))
    return grand, float((dev.sum(-1).abs() / torch.sqrt(var.sum(-1))).max())


def phase_int8(ds, f32_runs: dict, rng) -> tuple:
    """[24]: each run driven as in [4], K1 counted per run (20 of 20). The
    uplink bytes per round (``comm_summary``) beside the f32 plan's of the
    same local step and top-k ([4], [23]); one int8 round's profile, as
    [7]."""
    runs, launches = {}, {}
    for label, kw in INT8_RUNS:
        union_segsum.launches = 0
        runs[label] = drive(make_trainer(ds, "fedsubavg", DEV, sparse_int8=True, **kw), label)
        launches[label] = union_segsum.launches
        check(launches[label] == 20, f"{label}: K1 served {launches[label]}/20 rounds")
        f32 = f32_runs[label.replace("int8", "f32")]["comm"]
        mine = runs[label]["comm"]
        print(f"  {label}: uplink {mine['bytes_up_sparse'] / mine['rounds'] / 1e3:.1f} kB "
              f"per round against f32's {f32['bytes_up_sparse'] / f32['rounds'] / 1e3:.1f} "
              f"kB (dense {mine['bytes_up_dense'] / mine['rounds'] / 1e6:.2f} MB); downlink "
              f"{mine['bytes_down_sparse'] / mine['rounds'] / 1e3:.1f} kB; AUC "
              f"{runs[label]['auc']:.5f}")
    phase_profile(ds, runs["int8"]["steady_ms_per_round"], label="fedsubavg int8",
                  sparse_int8=True)
    grand, worst = int8_unbiased(rng)
    print(f"  int8 unbiased on the card: 256 draws of 16 x 64 x 25 rows; grand-mean z "
          f"{grand:.3f}, largest row z {worst:.3f}")
    check(abs(grand) <= 4.0 and worst <= 5.0,
          f"int8 rounding biased: grand z {grand}, row z {worst}")
    return runs, launches


def lstm_inputs(ds, rng, stacked: bool, k: int = 100, pooled: int = 500) -> dict:
    """One step's batch on the card: a cohort ``(K, I, B, ...)`` of ``k``
    clients, or a pooled ``(B, ...)`` batch of ``pooled`` samples, with the
    heat as ``heat_vocab``."""
    if stacked:
        ids = rng.choice(ds.num_clients, size=k, replace=False)
        batch = sample_cohort_batch(ds, ids, 5, 5, rng)
    else:
        batch = {key: v[0] for key, v in pooled_batches(ds, 1, pooled, rng).items()}
    out = {key: torch.from_numpy(np.ascontiguousarray(v)).to(DEV) for key, v in batch.items()}
    out["heat_vocab"] = torch.as_tensor(ds.heat.counts, dtype=torch.float32, device=DEV)
    return out


#: int8 rows on the paper's protocol: at D = 25 the rounding changes values,
#: so K1 aggregates rows that went through int8 and back
INT8_SUBMODEL = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(int8=True),
                          ServerUpdate("fedsubavg"))

#: [25]: make_round_step's modes on the LSTM; K1 launches expected per step
#: [25]: steps of each mode
ROUND_STEP_STEPS = 2
ROUND_STEP_MODES = (("fedsgd", "fedsgd", {}, False, 0),
                    ("fedsgd 4 microbatches", "fedsgd", dict(microbatches=4), False, 0),
                    ("sparse", "sparse", {}, False, 0),
                    ("replicated", "replicated", {}, True, 0),
                    ("sparse_replicated", "sparse_replicated", {}, True, 1),
                    ("int8 FedSgdLocal", RoundPlan(FedSgdLocal(),
                                                   RowSparseTransport(int8=True),
                                                   ServerUpdate("fedsubavg")), {}, False, 0),
                    ("int8 sparse_replicated", INT8_SUBMODEL, {}, True, 1))


def phase_round_steps(ds) -> dict:
    """[25]: ``ROUND_STEP_STEPS`` steps of each mode from the same initial
    parameters (the sparse modes update their table in place, so each mode
    takes a copy); loss finite, K1 counted per step, held to its plain
    version on the int8 plan's last step, then one step more profiled
    (device ops and device time, the busy share against the median host
    time of the steps). Then ``debug_checks``
    on and off in ``sparse`` mode (no K1: its atomics' order would differ
    between any two runs), a planted unsorted ``sub_ids``, and gather before
    backward at V = 2^22."""
    make_params, loss_fn, _ = task_bindings(ds, SEED)
    params0, axes = make_params(DEV)
    base = dict(num_clients=ds.num_clients, clients_per_round=100, local_iters=5,
                local_batch=5, lr=0.5, seed=SEED)
    out = {"launches": {}}
    for label, mode, kw, stacked, want in ROUND_STEP_MODES:
        rng = np.random.default_rng(SEED + 5)
        step = make_round_step(loss_fn, params0, axes, FedConfig(**base, **kw), mode=mode)
        params = {k: v.clone() for k, v in params0.items()}
        losses, ms, per_step, captured = [], [], [], {}
        ctx = capture_k1(captured) if mode is INT8_SUBMODEL else contextlib.nullcontext()
        with ctx:
            for _ in range(ROUND_STEP_STEPS):
                batch = lstm_inputs(ds, rng, stacked)
                torch.cuda.synchronize()
                union_segsum.launches = 0
                t0 = time.perf_counter()
                params, metrics = step(params, batch)
                losses.append(float(metrics["loss"]))
                ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append(union_segsum.launches)
        launches = sum(per_step)
        out["launches"][label] = launches
        check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss")
        check(per_step == [want] * ROUND_STEP_STEPS, f"{label}: K1 launched {per_step} times "
              f"in the {ROUND_STEP_STEPS} "
              f"steps, want {want} each")
        if captured:
            args, scale = captured["args"], captured["kw"]["scale"]
            ids, rows, v = args[0], args[1], args[5]
            union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
            err = check_k1(f"union_segsum[{label} step]", args, scale, union)
            out["k1_err"] = err
            print(f"  K1 at an {label} step: V={v} T={ids.numel()} D={rows.shape[-1]} "
                  f"cap={args[4]} union={union} max_abs_err={err:.3g}")
        extra = (f", sub_rows {int(metrics['sub_rows'])}, density "
                 f"{float(metrics['density']):.5f}" if "sub_rows" in metrics else "")
        batch = lstm_inputs(ds, rng, stacked)
        _, by_name, ops = device_profile(lambda: step(params, batch))
        dev_ms = sum(by_name.values()) / 1e3
        print(f"  {label}: losses {[round(x, 5) for x in losses]}, ms per step "
              f"{[round(x, 1) for x in ms]}, K1 {launches}{extra}; one step profiled: "
              f"{ops} device ops, {dev_ms:.3f} ms of device work "
              f"({dev_ms / statistics.median(ms) * 100:.1f}% busy)")

    cfg = FedConfig(**base)
    plain_plan = resolve_plan("sparse", cfg)
    results = []
    # deterministic kernels for the embedding's gradient (an accumulating
    # scatter), so that two runs may be held to each other bit for bit
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for plan in (plain_plan, dataclasses.replace(plain_plan, debug_checks=True)):
            rng = np.random.default_rng(SEED + 6)
            step = make_round_step(loss_fn, params0, axes, cfg, mode=plan)
            params = {k: v.clone() for k, v in params0.items()}
            losses = []
            for _ in range(ROUND_STEP_STEPS):
                params, metrics = step(params, lstm_inputs(ds, rng, False))
                losses.append(float(metrics["loss"]))
            results.append((losses, params))
    finally:
        torch.use_deterministic_algorithms(False)
    (l1, p1), (l2, p2) = results
    same = l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1)
    print(f"  debug_checks on and off, sparse mode, {ROUND_STEP_STEPS} steps: equal bit for "
          f"bit: {same}")
    check(same, "debug_checks changed the sparse step's losses or parameters")
    step = build_round_step(dataclasses.replace(plain_plan, debug_checks=True), loss_fn,
                            axes, params0, cfg)
    bad = torch.full((64,), -1, dtype=torch.int32, device=DEV)
    bad[:2] = torch.tensor([9, 3])
    try:
        step(ServerState({k: v.clone() for k, v in params0.items()}, (), 0),
             lstm_inputs(ds, np.random.default_rng(0), False), bad)
        raised = None
    except ValueError as e:
        raised = str(e)
    print(f"  planted unsorted sub_ids: {raised}")
    check(raised is not None and "ascending" in raised, "unsorted sub_ids did not raise")

    # gather before backward: the LSTM's table widened to the heavy shape's V
    v_heavy, d = SHAPES["heavy"][0], params0["embedding"].shape[1]
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    wide = {k: v.clone() for k, v in params0.items()}
    wide["embedding"] = torch.zeros((v_heavy, d), device=DEV)
    wide["embedding"][:ds.num_features] = params0["embedding"]
    param_bytes = sum(p.numel() * p.element_size() for p in wide.values())
    table_bytes = v_heavy * d * 4
    batch = lstm_inputs(ds, np.random.default_rng(SEED + 7), False)
    batch["heat_vocab"] = torch.cat([batch["heat_vocab"], torch.zeros(
        v_heavy - ds.num_features, device=DEV)])
    step = make_round_step(loss_fn, wide, axes, cfg, mode="sparse")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wide, metrics = step(wide, batch)
    loss = float(metrics["loss"])
    heavy_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - base_bytes
    print(f"  gather before backward at V = {v_heavy}, D = {d}: peak {peak / 2**20:.1f} MiB "
          f"above the earlier phases' tensors, against the parameters "
          f"{param_bytes / 2**20:.1f} MiB + one (V, D) f32 table {table_bytes / 2**20:.1f} "
          f"MiB; loss {loss:.5f}, {heavy_ms:.1f} ms, sub_rows {int(metrics['sub_rows'])}")
    check(math.isfinite(loss) and peak < param_bytes + table_bytes,
          f"gather before backward: peak {peak} bytes >= {param_bytes + table_bytes}")
    out["heavy"] = {"peak_bytes": peak, "param_bytes": param_bytes,
                    "table_bytes": table_bytes, "ms": heavy_ms}
    return out


def to_device(x, device):
    """``x`` with every tensor, RowSparse leaf included, on ``device``."""
    if isinstance(x, RowSparse):
        return RowSparse(x.ids.to(device), x.rows.to(device), x.num_rows)
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_device(v, device) for v in x)
    return x.to(device) if torch.is_tensor(x) else x


@contextlib.contextmanager
def capture_int8_stage(captured: dict):
    """Record the arguments of the round plan's compression and cohort
    aggregation, step by step, in ``captured``; the calls run."""
    real_compress, real_aggregate = (plan_mod.compress_delta_tree,
                                     plan_mod.sparse_cohort_aggregate)

    def compress_(*args, **kw):
        captured.setdefault("compress", []).append((args, kw))
        return real_compress(*args, **kw)

    def aggregate_(*args, **kw):
        captured.setdefault("aggregate", []).append((args, kw))
        return real_aggregate(*args, **kw)

    plan_mod.compress_delta_tree, plan_mod.sparse_cohort_aggregate = compress_, aggregate_
    try:
        yield
    finally:
        plan_mod.compress_delta_tree = real_compress
        plan_mod.sparse_cohort_aggregate = real_aggregate


def int8_stage_card_vs_host(captured: dict) -> float:
    """Each step's int8 rounding and cohort aggregation, on the card (K1)
    and on the host (the plain union), from the host step's client deltas
    and the host's noise: union ids exact, every aggregated leaf within
    1e-5. Returns the largest difference."""
    diff = 0.0
    for step_args in zip(captured["compress"], captured["aggregate"]):
        out = []
        for device in (DEV, torch.device("cpu")):
            (cargs, ckw), (aargs, akw) = to_device(step_args, device)
            out.append(aggregate_mod.sparse_cohort_aggregate(
                compress.compress_delta_tree(*cargs, **ckw), *aargs[1:], **akw))
        card, host = out
        for name, h in host.items():
            c = card[name]
            if isinstance(h, RowSparse):
                check(torch.equal(c.ids.cpu(), h.ids),
                      f"int8 stage '{name}': union ids differ")
                c, h = c.rows, h.rows
            diff = max(diff, float((c.cpu() - h).abs().max()))
            check(torch.allclose(c.cpu(), h, rtol=1e-5, atol=1e-5),
                  f"int8 stage '{name}': card and host differ by {diff}")
    return diff


def phase_new_card_vs_host(lr_small, lstm_small) -> None:
    """[26]: the replicated plan and int8 rows through the trainer (the
    noise drawn by the port's own stream on the host and copied to the
    card, so both see the same uniforms), then make_round_step fedsgd and
    sparse and the int8 submodel plan on the LSTM (D = 25, where the
    rounding changes values and K1 sums them; the noise from the host as
    above; its table held step by step, see the module's docstring), 3
    steps card against host, then Example 1. No case
    has a binding top-k: LR's tied rows would be broken by last-ulp sums
    differently on each side (ROADMAP Queue 3)."""
    phase_card_vs_host(lr_small, rounds=3, cases=(
        ("fedsubavg replicated", "fedsubavg", dict(sparse_local="replicated")),))
    host_uniform = compress.int8_uniform
    compress.int8_uniform = (lambda shape, seed, rounds, leaf, device:
                             host_uniform(shape, seed, rounds, leaf, "cpu").to(device))
    try:
        phase_card_vs_host(lr_small, rounds=3, cases=(
            ("fedsubavg int8", "fedsubavg", dict(sparse_int8=True)),
            ("fedsubavg int8 replicated", "fedsubavg",
             dict(sparse_int8=True, sparse_local="replicated"))))
    finally:
        compress.int8_uniform = host_uniform

    make_params, loss_fn, _ = task_bindings(lstm_small, SEED)
    cfg = FedConfig(num_clients=lstm_small.num_clients, clients_per_round=100,
                    local_iters=5, local_batch=5, lr=0.5, seed=SEED)
    for label, mode, stacked in (("fedsgd", "fedsgd", False), ("sparse", "sparse", False),
                                 ("int8 sparse_replicated", INT8_SUBMODEL, True)):
        runs, captured = [], {}
        compress.int8_uniform = (lambda shape, seed, rounds, leaf, device:
                                 host_uniform(shape, seed, rounds, leaf, "cpu").to(device))
        try:
            for device in (DEV, torch.device("cpu")):
                params, axes = make_params(device)
                step = make_round_step(loss_fn, params, axes, cfg, mode=mode)
                rng, losses = np.random.default_rng(SEED + 8), []
                ctx = (capture_int8_stage(captured) if device.type == "cpu"
                       else contextlib.nullcontext())
                with ctx:
                    for _ in range(3):
                        batch = {k: v.to(device)
                                 for k, v in lstm_inputs(lstm_small, rng, stacked).items()}
                        params, metrics = step(params, batch)
                        losses.append(float(metrics["loss"]))
                runs.append((losses, params))
            stage = int8_stage_card_vs_host(captured) if "compress" in captured else None
        finally:
            compress.int8_uniform = host_uniform
        (lc, pc), (lh, ph) = runs
        dl = max(abs(a - b) for a, b in zip(lc, lh))
        diffs = {k: (pc[k].cpu() - ph[k]).abs() for k in pc}
        print(f"  lstm make_round_step {label}: 3 steps card vs host: max |loss diff| "
              f"{dl:.3g}, max |param diff| by leaf "
              + ", ".join(f"{k} {float(d.max()):.3g}" for k, d in diffs.items()))
        # int8 tables are held stage by stage: the card's and the host's
        # local deltas differ in the last ulp, and a ulp near a rounding
        # boundary moves floor(x / s + u) by one quantum, s = max|row| / 127
        held = {k for k in pc if not (mode is INT8_SUBMODEL and axes[k][:1] == ("vocab",))}
        if stage is not None:
            table = [(k, int((d > 1e-5).sum()), d.numel()) for k, d in diffs.items()
                     if k not in held]
            print(f"    int8 rounding and K1 of each step, card against host from the "
                  f"host's deltas: max |diff| {stage:.3g}; table elements off by more "
                  f"than 1e-5 after 3 steps (the rounding's flips): {table}")
        check(dl <= 1e-5 and all(torch.allclose(pc[k].cpu(), ph[k], rtol=1e-5, atol=1e-5)
                                 for k in held), f"lstm {label}: card and host differ")

    n = 100                      # examples/example1_illconditioning.py
    counts = np.array([1.0, float(n)])
    kappas = []
    for device in (DEV, torch.device("cpu")):
        h = torch.diag(torch.tensor([2.0 / n, 2.0], device=device))
        kappas.append((condition_number(h),
                       condition_number(preconditioned_hessian(h, counts, float(n)))))
    (kc, kc_hat), (kh, kh_hat) = kappas
    print(f"  Example 1: kappa(H) card {kc:.6f} host {kh:.6f}; kappa(D^1/2 H D^1/2) card "
          f"{kc_hat:.6f} host {kh_hat:.6f}")
    check(abs(kc - kh) <= 1e-5 * kh and abs(kc_hat - kh_hat) <= 1e-5 * kh_hat
          and abs(kc - n) <= 1e-3 * n, "Example 1's condition numbers differ")


# ---------------------------------------------------------------------------
# Round telemetry, the trace sink, profile_dir and the buffered-async engine
# ---------------------------------------------------------------------------

#: git-ignored; traces, sinks and checkpoints of [27]-[30]
OUT_DIR = ROOT / "build" / "chip_smoke"
#: RoundTelemetry fields compared exactly between card and host
TEL_EXACT = ("dropped_ids", "dropped_per_client", "union_size", "agg_rows",
             "heat_hist", "staleness_hist", "buffer_occupancy", "round", "event")


def params_diff(a: dict, b: dict) -> float:
    return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)


def params_close(a: dict, b: dict, tol: float) -> bool:
    """Every leaf within ``tol`` (``torch.allclose``, rtol = atol = tol)."""
    return all(torch.allclose(a[k].cpu(), b[k].cpu(), rtol=tol, atol=tol) for k in a)


def telemetry_diff(card: list, host: list) -> float:
    """Round events of two runs: integer fields equal; returns the largest
    difference of the float fields (``None`` fields must agree)."""
    check(len(card) == len(host), f"{len(card)} against {len(host)} telemetry events")
    worst = 0.0
    for c, h in zip(card, host):
        check(set(c) == set(h), "telemetry keys differ")
        for name, w in h.items():
            g = c[name]
            if name in TEL_EXACT or name == "comm" or w is None:
                check(g == w, f"telemetry {name}: card {g} host {w}")
            else:
                worst = max(worst, float(np.abs(np.asarray(g) - np.asarray(w)).max()))
    return worst


def ops_per_round(tr: FederatedTrainer, n: int = 3) -> tuple:
    """Device ops and device ms per round over ``n`` warm ``run_round``
    calls (torch.profiler through ``device_profile``)."""
    _, by_name, ops = device_profile(lambda: [tr.run_round() for _ in range(n)])
    return ops / n, sum(by_name.values()) / n / 1e3


def stretch_firsts(tr: FederatedTrainer) -> list:
    """Wrap the trainer's dispatch marker: the returned list gains, per
    dispatch, the round count before it and whether it was a first."""
    seen, mark = [], tr._mark_dispatch

    def marked(key):
        before = tr._rounds_run
        mark(key)
        seen.append((before, tr._last_dispatch_first))

    tr._mark_dispatch = marked
    return seen


def phase_telemetry(ds, lstm_ds) -> dict:
    """[27]: fedsubavg at [4]'s configuration, 20 rounds through ``run``
    and 20 through ``run(engine=True)``, each with telemetry on (a JSONL
    sink), off, and off again (the control); K1 20 of 20 per run; on
    against off: records within 1e-6, parameters within 1e-5 (K1's atomic
    order differs between any two runs, the control's too); every round's heat
    histogram sums to its union size, no drop at the pow2 capacity; the
    sink reads back; first dispatches booked exactly in the stretches that
    had one. Then ms and device ops per round on and off, the LSTM's sparse
    ``FedSgdLocal`` step (no K1) on and off bit for bit under deterministic
    algorithms, and a planted capacity of 16 against a numpy count."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out, trainers = {"launches": {}}, {}
    for engine in (False, True):
        for tel in (True, False, None):
            # None: a second run with telemetry off, the control for K1's order
            label = (f"run{'(engine=True)' if engine else ''} telemetry "
                     f"{'on' if tel else 'off'}{' again' if tel is None else ''}")
            path = OUT_DIR / f"sink_engine{int(engine)}.jsonl"
            tr = make_trainer(ds, "fedsubavg", DEV, telemetry=bool(tel),
                              sink=TraceSink(str(path)) if tel else None)
            firsts = stretch_firsts(tr)
            union_segsum.launches = 0
            tr.run(20, eval_every=10, engine=engine)
            launches = union_segsum.launches
            out["launches"][label] = launches
            check(launches == 20, f"{label}: K1 served {launches}/20 rounds")
            # run_round counts the round before its dispatch, run_rounds after
            per_stretch = [any(f for r, f in firsts if (r - (not engine)) // 10 == i)
                           for i in range(2)]
            booked = [h.compile_time > 0 for h in tr.history]
            check(booked == per_stretch and booked[0],
                  f"{label}: compile_time {[h.compile_time for h in tr.history]} against "
                  f"first dispatches by stretch {per_stretch}")
            trainers[(engine, tel)] = tr
            if tel:
                tr.sink.close()
                events = read_events(str(path))
                rounds = [e for e in events if e["event"] == "round"]
                check({e["event"] for e in events} == {"round", "record"}
                      and len(rounds) == 20 and len(events) == 22, f"{label}: sink events")
                check(all(sum(e["heat_hist"]) == e["union_size"] > 0 for e in rounds),
                      f"{label}: a heat histogram does not sum to its union")
                check(all(e["dropped_ids"] == 0 and e["dropped_mass"] == 0.0 for e in rounds),
                      f"{label}: ids dropped at the pow2 capacity")
                check(tr.telemetry_log == rounds, f"{label}: sink and telemetry_log differ")
            print(f"  {label}: K1 {launches}/20; records' steady ms/round "
                  f"{[round(h.wall_time * 1e3, 2) for h in tr.history]}, first-dispatch s "
                  f"{[round(h.compile_time, 4) for h in tr.history]}")
        on, off, again = (trainers[(engine, t)] for t in (True, False, None))
        dl = max(max(abs(a.train_loss - b.train_loss), abs(a.test_metric - b.test_metric))
                 for a, b in zip(on.history, off.history))
        dp = params_diff(on.state.params, off.state.params)
        dc = params_diff(again.state.params, off.state.params)
        print(f"  on against off ({'engine' if engine else 'loop'}): max |train loss or AUC "
              f"diff| {dl:.3g}, max |param diff| {dp:.3g} (off against off: {dc:.3g}, K1's "
              f"atomic order on rows scaled by up to N / n_m = {ds.num_clients}); union "
              f"size mean {on.telemetry_summary()['mean_union_size']:.1f}")
        # the parameters as card against host ([5]): 1e-6 does not hold between
        # any two runs of K1 here, telemetry or not
        check(dl <= 1e-6 and params_close(on.state.params, off.state.params, 1e-5),
              f"telemetry on and off differ: {dl}, {dp}")
    for tel in (True, False):
        tr = trainers[(False, tel)]
        ms = statistics.mean(h.wall_time for h in tr.history) * 1e3
        ops, dev_ms = ops_per_round(tr)
        out["on" if tel else "off"] = {"ms_per_round": ms, "device_ops_per_round": ops,
                                       "device_ms_per_round": dev_ms}
        print(f"  telemetry {'on' if tel else 'off'}: {ms:.2f} ms/round steady (run), "
              f"{ops:.0f} device ops and {dev_ms:.3f} ms of device work per round")

    make_params, loss_fn, _ = task_bindings(lstm_ds, SEED)
    params0, axes = make_params(DEV)
    cfg = FedConfig(num_clients=lstm_ds.num_clients, clients_per_round=100, local_iters=5,
                    local_batch=5, lr=0.5, seed=SEED)
    results = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for tel in (False, True):
            rng = np.random.default_rng(SEED + 6)
            step = make_round_step(loss_fn, params0, axes, cfg, mode="sparse", telemetry=tel)
            params, losses, tels = {k: v.clone() for k, v in params0.items()}, [], []
            for _ in range(3):
                params, m = step(params, lstm_inputs(lstm_ds, rng, False))
                losses.append(float(m["loss"]))
                tels.append(m.get("telemetry"))
            results.append((losses, params, tels))
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, p0, _), (l1, p1, tels) = results
    same = l0 == l1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    host = [telemetry_to_host(t) for t in tels]
    print(f"  LSTM sparse FedSgdLocal, 3 steps, telemetry on and off: equal bit for bit: "
          f"{same}; union sizes {[h['union_size'] for h in host]}, delta norms "
          f"{[round(h['delta_norm_pre'], 5) for h in host]}")
    check(same, "telemetry changed the sparse FedSgdLocal step")
    check(all(sum(h["heat_hist"]) == h["union_size"] > 0 for h in host), "LSTM heat hist")

    make_params, loss_fn, _ = task_bindings(ds, SEED)
    params, axes = make_params(DEV)
    cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=100, local_iters=5,
                    local_batch=5, lr=0.5, seed=SEED)
    step = build_round_step(resolve_plan("sparse_replicated", cfg, feature_key="features"),
                            loss_fn, axes, params, cfg, telemetry=True)
    rng = np.random.default_rng(SEED + 9)
    batch = sample_cohort_batch(ds, rng.choice(ds.num_clients, 100, replace=False), 5, 5, rng)
    feats = batch["features"].reshape(100, -1)
    valid = np.where((feats >= 0) & (feats < ds.num_features), feats, -1)
    cap = 16
    small = unique_ids_padded(torch.from_numpy(valid).to(DEV), cap)
    dev_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(DEV) for k, v in batch.items()}
    dev_batch["heat_vocab"] = torch.as_tensor(ds.heat.counts, dtype=torch.float32, device=DEV)
    _, m = step(ServerState(params, (), 0), dev_batch, small)
    tel = telemetry_to_host(m["telemetry"])
    dropped, mass = [], 0
    for row in valid:
        kept = np.unique(row[row >= 0])[:cap]
        dropped.append(len(np.unique(row[row >= 0])) - kept.size)
        mass += int(((row >= 0) & ~np.isin(row, kept)).sum())
    print(f"  planted capacity {cap}, K = 100: dropped ids {tel['dropped_ids']} (numpy "
          f"{sum(dropped)}), mass {tel['dropped_mass']:.0f} (numpy {mass}), union "
          f"{tel['union_size']}")
    check(tel["dropped_per_client"] == dropped and tel["dropped_ids"] == sum(dropped) > 0
          and tel["dropped_mass"] == float(mass), "planted capacity: drop counts differ")
    return out


def phase_profile_dir(ds) -> dict:
    """[28]: ``run(2, profile_dir=...)`` writes one trace holding its
    ``rounds[a:b]`` range and K1's events, as many as K1's launch counter
    rose by (the rule of ``device_profile``: a trace short of them is the
    profiler's miss, taken again)."""
    tr = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
    tr.run_round()
    for attempt in range(5):
        pdir = OUT_DIR / f"profile_{attempt}"
        shutil.rmtree(pdir, ignore_errors=True)
        torch.cuda.synchronize()
        before = union_segsum.launches
        a = tr._rounds_run
        tr.run(2, eval_every=2, profile_dir=str(pdir))
        rise = union_segsum.launches - before
        files = sorted(pdir.glob("*.pt.trace.json"))
        check(len(files) == 1, f"profile_dir holds {files}")
        events = json.loads(files[0].read_text())["traceEvents"]
        ranges = sorted({e["name"] for e in events
                         if re.fullmatch(r"rounds\[\d+:\d+\]", str(e.get("name", "")))})
        k1 = sum(1 for e in events if e.get("cat") == "kernel"
                 and "union_segsum_kernel" in str(e.get("name", "")))
        if k1 == rise:
            break
        print(f"    (the trace holds {k1} K1 events against {rise} launches: profiling again)")
    print(f"  {files[0].name}: {files[0].stat().st_size / 1e6:.2f} MB, {len(events)} events, "
          f"ranges {ranges}, K1 events {k1} = launches {rise}")
    check(k1 == rise == 2 and ranges == [f"rounds[{a}:{a + 2}]"],
          f"profile_dir: ranges {ranges}, K1 {k1} against {rise}")
    return {"k1_events": k1, "ranges": ranges}


def ops_by_range(prof, names) -> dict:
    """``{name: [ranges, device ops, device us, host us]}`` for each named
    host range of a profile: a device event belongs to the range its launch
    call (matched by correlation id) falls in."""
    path = OUT_DIR / "ranges.pt.trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = {n: [(e["ts"], e["ts"] + e["dur"]) for e in events
                 if e.get("name") == n and e.get("cat") == "user_annotation"] for n in names}
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    out = {n: [len(s), 0, 0.0, sum(b - a for a, b in s)] for n, s in spans.items()}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        t = launch.get(e.get("args", {}).get("correlation"))
        for n, s in spans.items():
            if t is not None and any(a <= t <= b for a, b in s):
                out[n][1] += 1
                out[n][2] += e["dur"]
    return out


ASYNC_SIM = dict(num_rounds=20, delay="lognormal", delay_scale=0.5, lognormal_sigma=1.2,
                 straggler_frac=0.05, dropout_frac=0.02, seed=8)


def phase_async(ds, sync_ms: float) -> dict:
    """[29]: (a) zero delay, ``buffer_size = K``: ``run_async`` over 10
    waves against ``run_rounds(10)`` within 1e-5, the next numpy draw
    equal, K1 10 of 10 fires; (b) ``ASYNC_SIM`` with 25-arrival buffers,
    polynomial staleness and EMA heat: K1 once per fire, each fire's
    staleness histogram sums to 25, loss falls and AUC > 0.5, the rows only
    dropped-out clients touch unchanged; its time per event and per fire, a
    profiled rerun's device ops per dispatch and per fire, K1 at the fire's
    shape; (c) the same schedule with 100-arrival buffers and constant
    weights."""
    from torch.autograd import DeviceType

    out = {"launches": {}}
    sync = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
    asyn = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
    ls = sync.run_rounds(10)
    union_segsum.launches = 0
    la = asyn.run_async(ArrivalSim(num_rounds=10))
    launches = union_segsum.launches
    out["launches"]["zero delay"] = launches
    dl = max(abs(a - b) for a, b in zip(ls, la))
    dp = params_diff(sync.state.params, asyn.state.params)
    same_draw = sync.np_rng.integers(1 << 30) == asyn.np_rng.integers(1 << 30)
    print(f"  (a) zero delay, M = K = 100, 10 waves: K1 {launches}/10 fires; against "
          f"run_rounds(10): max |loss diff| {dl:.3g}, max |param diff| {dp:.3g}; next "
          f"draw equal: {same_draw}")
    check(launches == 10 and dl <= 1e-5 and same_draw and len(la) == 10
          and params_close(sync.state.params, asyn.state.params, 1e-5),
          "zero-delay async differs from run_rounds")

    for tag, srv in (("b", BufferedAsyncServerUpdate(buffer_size=25, staleness="polynomial",
                                                     heat="ema")),
                     ("c", BufferedAsyncServerUpdate(buffer_size=100, heat="ema"))):
        sim = ArrivalSim(**ASYNC_SIM)
        sch = sim.compile(100, srv.buffer_size)
        tr = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
        waves, sample = [], tr._sample_sparse_cohort

        def recorded():
            c, f = sample()
            waves.append(f)
            return c, f

        tr._sample_sparse_cohort = recorded
        loss0, table0 = tr.train_loss(), tr.state.params["w"].clone()
        captured = {}
        union_segsum.launches = 0
        torch.cuda.synchronize()
        with capture_k1(captured):
            t0 = time.perf_counter()
            losses = tr.run_async(sim, server=srv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = union_segsum.launches
        out["launches"][tag] = launches
        fires = tr.telemetry_log[-sch.num_fires:]
        loss1, auc = tr.train_loss(), tr.evaluate()
        feats = np.concatenate(waves)

        def touched(mask):
            ids = feats[mask].ravel()
            return np.unique(ids[(ids >= 0) & (ids < ds.num_features)])

        private = np.setdiff1d(touched(sch.dropped), touched(~sch.dropped))
        at = torch.from_numpy(private).to(DEV)
        untouched = torch.equal(tr.state.params["w"][at], table0[at])
        moved = int((tr.state.params["w"] != table0).any(-1).sum())
        res = {"events": sch.num_events, "fires": sch.num_fires, "wall_s": wall,
               "ms_per_event": wall / sch.num_events * 1e3,
               "ms_per_fire": wall / sch.num_fires * 1e3, "launches": launches}
        out[tag] = res
        print(f"  ({tag}) M = {srv.buffer_size}, {srv.staleness} staleness, EMA heat: "
              f"{sch.num_tasks} tasks, {int(sch.dropped.sum())} dropped, {sch.num_events} "
              f"events, {sch.num_slots} slots, {sch.num_fires} fires (simulated speedup over "
              f"the barrier {sch.sim_speedup():.2f}); K1 {launches}; {wall:.2f} s: "
              f"{res['ms_per_event']:.3f} ms/event, {res['ms_per_fire']:.2f} ms/fire "
              f"(a synchronous round {sync_ms:.2f} ms)")
        print(f"    loss {loss0:.5f} -> {loss1:.5f}, AUC {auc:.5f}; fire losses "
              f"{[round(x, 4) for x in losses[:3]]} ... {[round(x, 4) for x in losses[-3:]]}; "
              f"staleness of the last fire {fires[-1]['staleness_hist']}; "
              f"{private.size} rows only dropped clients touch, unchanged: {untouched} "
              f"({moved} rows moved)")
        check(launches == sch.num_fires == len(losses), f"({tag}) K1 {launches} against "
              f"{sch.num_fires} fires")
        check(all(sum(e["staleness_hist"]) == srv.buffer_size for e in fires),
              f"({tag}) a fire's staleness histogram")
        check(all(math.isfinite(x) for x in losses) and loss1 < loss0 and auc > 0.5,
              f"({tag}) loss {loss0} -> {loss1}, AUC {auc}")
        check(private.size > 0 and untouched, f"({tag}) dropped clients' rows")
        if tag == "b":
            args, scale = captured["args"], captured["kw"]["scale"]
            ids, rows, v = args[0], args[1], args[5]
            union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
            err = check_k1("union_segsum[async fire]", args, scale, union)
            again = make_trainer(ds, "fedsubavg", DEV, telemetry=True)
            prof, by_name, ops = device_profile(lambda: again.run_async(sim, server=srv))
            # K1's device ops and time per call from the run's own profile: a
            # short profile of a few K1 calls after [28]'s has come back empty
            # five times in a row
            k1_us = [us for name, us in by_name.items() if "union_segsum_kernel" in name]
            k1_ops = sum(1 for e in prof.events() if "union_segsum_kernel" in e.name
                         and e.device_type == DeviceType.CUDA)
            timed = time_k1_k2(args, scale, "async fire", keys=("k1",), profiled={
                "k1": (k1_ops / sch.num_fires, sum(k1_us) / sch.num_fires / 1e3)})
            out["k1"] = {"shape": timed["shape"], "max_abs_err": err, **timed["k1"]}
            names = ("async_engine.dispatch", "async_engine.arrive", "async_engine.fire")
            ranges = ops_by_range(prof, names)
            n_dispatch = int((sch.kind == 0).sum())
            d, a, f = (ranges[n] for n in names)
            res.update(device_ops=ops, device_ms=sum(by_name.values()) / 1e3,
                       ops_per_dispatch=d[1] / n_dispatch,
                       ranges={n[len("async_engine."):]: {
                           "count": r[0], "device_ops_each": r[1] / max(r[0], 1),
                           "device_ms_each": r[2] / 1e3 / max(r[0], 1),
                           "host_ms_each_profiled": r[3] / 1e3 / max(r[0], 1)}
                           for n, r in ranges.items()})
            print(f"    profiled rerun: {ops} device ops, {res['device_ms']:.2f} ms of device "
                  f"work ({res['device_ms'] / (wall * 1e3) * 100:.1f}% of the unprofiled "
                  f"run's wall time); {res['ops_per_dispatch']:.2f} device ops per dispatch")
            for n, r in res["ranges"].items():
                print(f"      {r['count']} {n} ranges: {r['device_ops_each']:.1f} device ops, "
                      f"{r['device_ms_each']:.4f} ms of device work and "
                      f"{r['host_ms_each_profiled']:.3f} ms of host time (profiled) each")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            for name, us in top:
                print(f"      {us / 1e3:.3f} ms  {name[:100]}")
            check(f[0] == sch.num_fires and d[1] + a[1] + f[1] <= ops,
                  f"ranges {ranges} against {ops} device ops")
    return out


def phase_async_card_vs_host(small) -> None:
    """[30]: ``ASYNC_SIM`` over 6 waves of K = 20 on 200 clients, (b)'s
    server slot, telemetry on and a top-k above every client's submodel, on
    the card and on ``device="cpu"``: losses, parameters and the EMA heat
    within 1e-5, telemetry's integer fields equal and its floats within
    1e-5. Then a mid-run checkpoint: the first half of the events on the
    card, ``save_checkpoint``, ``load_checkpoint`` on the host into a fresh
    ``AsyncState``, the second half there; it equals the uninterrupted host
    run within 1e-5."""
    sim = ArrivalSim(**{**ASYNC_SIM, "num_rounds": 6})
    srv = BufferedAsyncServerUpdate(buffer_size=25, staleness="polynomial", heat="ema")
    kw = dict(clients_per_round=20, sparse_topk=1 << 16)
    runs = []
    for device in (DEV, torch.device("cpu")):
        tr = make_trainer(small, "fedsubavg", device, telemetry=True, **kw)
        runs.append((tr, tr.run_async(sim, server=srv)))
    (card, lc), (host, lh) = runs
    dl = max(abs(a - b) for a, b in zip(lc, lh))
    dp = params_diff(card.state.params, host.state.params)
    dh = float((card._async_heat_ema.cpu() - host._async_heat_ema).abs().max())
    dt = telemetry_diff(card.telemetry_log, host.telemetry_log)
    print(f"  {len(lc)} fires card vs host: max |loss diff| {dl:.3g}, |param diff| {dp:.3g}, "
          f"|heat EMA diff| {dh:.3g}, telemetry integers equal, floats within {dt:.3g}")
    check(len(lc) == len(lh) > 0 and max(dl, dh, dt) <= 1e-5
          and params_close(card.state.params, host.state.params, 1e-5),
          f"async card and host differ: {dl}, {dp}, {dh}, {dt}")

    mid = str(OUT_DIR / "async_mid")
    part = make_trainer(small, "fedsubavg", DEV, telemetry=True, **kw).prepare_async(sim, srv)
    sch = part.schedule
    cut = sch.num_events // 2
    half, _ = part.engine.run(part.state, sch.slice_events(0, cut), part.tasks,
                              part.sub_ids, part.feats)
    save_checkpoint(mid, half, step=cut)
    rest = make_trainer(small, "fedsubavg", "cpu", telemetry=True, **kw).prepare_async(sim, srv)
    resumed = load_checkpoint(mid, rest.state)
    done, _ = rest.engine.run(resumed, sch.slice_events(cut, sch.num_events), rest.tasks,
                              rest.sub_ids, rest.feats)
    dp = params_diff(done.server.params, host.state.params)
    dh = float((done.heat_ema - host._async_heat_ema).abs().max())
    print(f"  mid-run checkpoint after {cut} of {sch.num_events} events ({half.arrivals} "
          f"arrivals, {half.server.rounds} fires, {half.buf_count} buffered) on the card, "
          f"resumed on the host: max |param diff| {dp:.3g}, |heat EMA diff| {dh:.3g} "
          f"against the uninterrupted host run")
    check(done.server.rounds == len(lh) and dh <= 1e-5
          and params_close(done.server.params, host.state.params, 1e-5),
          f"checkpoint resume differs: {dp}, {dh}")


# ---------------------------------------------------------------------------
# Cohort-sharded rounds over torch.distributed ([31]-[33])
# ---------------------------------------------------------------------------

#: the join of a spawned mesh: a rank stuck in a collective fails the run
MESH_TIMEOUT_S = 480.0
#: [33]: make_round_step's modes on the mesh (label, mode, stacked, K, debug)
MESH_STEP_MODES = (("fedsgd", "fedsgd", False, 100, False),
                   ("sparse", "sparse", False, 100, False),
                   ("replicated", "replicated", True, 100, False),
                   ("sparse_replicated", "sparse_replicated", True, 100, False),
                   ("sparse_replicated K=3 debug_checks", "sparse_replicated", True, 3, True))


def cpu_tree(tree: dict) -> dict:
    return {k: v.detach().cpu() for k, v in tree.items()}


def mesh_drive(tr: FederatedTrainer, rounds: int) -> dict:
    """Half the rounds through ``run_round`` (timed one by one), the rest
    through ``run(engine=True)`` with the evaluation at its end; K1's
    launches counted from 0."""
    n1 = rounds // 2
    union_segsum.launches = 0
    losses, ms = [], []
    for _ in range(n1):
        t0 = time.perf_counter()
        losses.append(tr.run_round())
        ms.append((time.perf_counter() - t0) * 1e3)
    tr.run(rounds - n1, eval_every=rounds - n1, engine=True)
    rec = tr.history[-1]
    return {"rounds": rounds, "loss": losses, "ms": ms, "train_loss": rec.train_loss,
            "auc": rec.test_metric,
            "launches": union_segsum.launches, "params": cpu_tree(tr.state.params),
            "comm": tr.comm_summary()}


def mesh_trainer_job(mesh, job: dict) -> dict:
    """A trainer on the mesh: the job's algorithm and combine, ``rounds``
    rounds by ``mesh_drive``; the last round's collective counters, and
    with ``capture`` the inputs of the last round's K1 calls."""
    plan = RoundPlan(SubmodelReplicatedLocal(), RowSparseTransport(),
                     ServerUpdate(job["alg"]),
                     sharding=CohortSharding(mesh, combine=job["combine"]))
    tr = make_trainer(job["ds"], job["alg"], mesh.device, plan=plan, mesh=mesh)
    calls = []

    def capture(*args, **kw):
        calls.append((args, kw))
        return union_segsum(*args, **kw)

    if job.get("capture"):
        aggregate_mod.union_segsum = capture
    try:
        out = mesh_drive(tr, job["rounds"])
    finally:
        aggregate_mod.union_segsum = union_segsum
    out["counters"] = dict(mesh.counters)
    out["combine"] = {name: pick_combine(p.shape[0], p[0].numel(), job["combine"])
                      for name, p in tr.state.params.items() if name in tr._sparse_paths}
    per_round = out["launches"] // job["rounds"]
    out["k1_calls"] = [(tuple(a.cpu() if torch.is_tensor(a) else a for a in args), kw)
                       for args, kw in calls[len(calls) - per_round:]] if calls else []
    return out


def mesh_steps_job(mesh, job: dict) -> dict:
    """[33]: ``make_round_step`` on the LSTM's inputs, each mode of
    ``MESH_STEP_MODES`` 3 steps on the mesh; rank 0 also runs the unsharded
    step on the same batches. K1 and the collective counters per step, the
    counters held to ``round_collective_budget`` and, on the sparse
    transport, their drift from ``sharded_combine_bytes`` ([63])."""
    ds = job["ds"]
    make_params, loss_fn, _ = task_bindings(ds, SEED)
    params0, axes = make_params(mesh.device)
    cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=100, local_iters=5,
                    local_batch=5, lr=0.5, seed=SEED)
    out = {}
    for label, mode, stacked, k, debug in MESH_STEP_MODES:
        plan = dataclasses.replace(resolve_plan(mode, cfg), debug_checks=debug)
        sharded = dataclasses.replace(plan, sharding=CohortSharding(mesh))
        step = make_round_step(loss_fn, params0, axes, cfg, mode=sharded)
        plain = make_round_step(loss_fn, params0, axes, cfg, mode=plan)
        ps = {n: v.clone() for n, v in params0.items()}
        pu = {n: v.clone() for n, v in params0.items()}
        rng = np.random.default_rng(SEED + 8)
        res = {"loss": [], "plain_loss": [], "launches": [], "counters_equal_budget": [],
               "ms": []}
        for _ in range(3):
            batch = lstm_inputs(ds, rng, stacked, k=k)
            budget = round_collective_budget(sharded, axes, ps, cfg, batch)
            if DEV.type == "cuda":
                torch.cuda.synchronize()
            union_segsum.launches = 0
            t0 = time.perf_counter()
            ps, m = step(ps, batch)
            res["loss"].append(float(m["loss"]))
            res["ms"].append((time.perf_counter() - t0) * 1e3)
            res["launches"].append(union_segsum.launches)
            res["counters_equal_budget"].append(mesh.counters == budget["components"])
            res["by_op"] = mesh.by_op()
            if sharded.transport.sparse:
                res.setdefault("drift", []).append(comm_drift(
                    sharded, axes, ps, cfg, batch, measured=res["by_op"]).to_dict())
            if mesh.rank == 0:
                pu, mu = plain(pu, batch)
                res["plain_loss"].append(float(mu["loss"]))
        res["params"] = cpu_tree(ps)
        if mesh.rank == 0:
            res["plain_params"] = cpu_tree(pu)
        out[label] = res
    return out


MESH_JOBS = {"trainer": mesh_trainer_job, "steps": mesh_steps_job}


def probe_mesh(mesh) -> None:
    """The backend's all-reduce and all-gather take the device's tensors."""
    rank, world = mesh.rank, mesh.size
    x = torch.full((3,), float(rank + 1), device=mesh.device)
    s, g = mesh.psum(x, "probe"), mesh.all_gather(x.to(torch.int32), "probe:gather")
    check(s.device == mesh.device
          and torch.equal(s.cpu(), torch.full((3,), world * (world + 1) / 2)),
          f"rank {rank}: all-reduce of a {mesh.device} tensor gave {s}")
    check(torch.equal(g[:, 0].cpu(), torch.arange(1, world + 1, dtype=torch.int32)),
          f"rank {rank}: all-gather of a {mesh.device} tensor gave {g}")


def mesh_rank(rank: int, world: int, backend: str, store: str, out_dir: str,
              jobs: list, device: str) -> None:
    """One rank of a cohort mesh spawned on this host: every rank on the
    parent's device (the one card). A job runs on the mesh of the first
    ``job["world"]`` ranks (a group of its own below the whole world), and
    ranks past it skip it. Checks that the backend's all-reduce and
    all-gather take the device's tensors on each mesh, runs ``jobs`` and
    saves its results for the parent, by world size."""
    import torch.distributed as dist

    global DEV
    DEV = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_cohort_mesh(device=DEV, backend=backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        meshes = {world: mesh}
        for w in sorted({job["world"] for job in jobs} - {world}):
            group = dist.new_group(list(range(w)))
            if rank < w:
                meshes[w] = CohortMesh(rank=rank, size=w, device=mesh.device, group=group)
        results: dict = {}
        for w, m in sorted(meshes.items()):
            probe_mesh(m)
        for job in jobs:
            if rank < job["world"]:
                results.setdefault(job["world"], {})[job["label"]] = MESH_JOBS[job["kind"]](
                    meshes[job["world"]], job)
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
        mesh.barrier()
    finally:
        mesh.destroy()


def run_mesh(world: int, backend: str, jobs: list) -> dict:
    """Spawn ``world`` ranks of ``mesh_rank`` on the card; each job's world
    size's ranks' results (``{world: [rank 0's, rank 1's, ...]}``)."""
    out_dir = Path(tempfile.mkdtemp(prefix=f"mesh{world}_", dir=ROOT / "build"))
    t0 = time.perf_counter()
    try:
        spawn_ranks(mesh_rank, world, args=(world, backend, str(out_dir / "store"),
                                            str(out_dir), jobs, str(DEV)),
                    timeout_s=MESH_TIMEOUT_S)
        res = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"  {world} rank(s), {backend}, meshes of {sorted({j['world'] for j in jobs})} "
          f"ranks: spawned, ran and joined in {time.perf_counter() - t0:.1f} s")
    return {w: [r[w] for r in res[:w]] for w in sorted({j["world"] for j in jobs})}


def run_mesh_here(jobs: list) -> list:
    """A 1-rank NCCL mesh in this process: the jobs' results (as a rank's)."""
    store = Path(tempfile.mkdtemp(prefix="nccl_", dir=ROOT / "build"))
    t0 = time.perf_counter()
    mesh = make_cohort_mesh(device=DEV, backend="nccl", init_method=f"file://{store / 's'}",
                            rank=0, world_size=1)
    try:
        probe_mesh(mesh)
        results = {job["label"]: MESH_JOBS[job["kind"]](mesh, job) for job in jobs}
    finally:
        mesh.destroy()
        shutil.rmtree(store, ignore_errors=True)
    print(f"  1 rank, nccl, in this process: ran in {time.perf_counter() - t0:.1f} s")
    return [results]


def rank_spread(ranks: list, key: str) -> float:
    """Largest difference of any rank's ``params`` from rank 0's under ``key``."""
    return max(params_diff(r[key]["params"], ranks[0][key]["params"]) for r in ranks)


#: rounds of [31] (LR) and [32] (DIN) on the mesh and on one device
MESH_LR_ROUNDS, MESH_DIN_ROUNDS = 20, 10


def phase_mesh_runs(lr_ds, din_ds, lstm_ds) -> tuple:
    """[31]-[33]'s runs: the unsharded trainers on the card, then 1 rank
    on NCCL in this process (LR) and one spawn of 4 gloo ranks: 2 of them
    (LR, DIN and the round steps of [33]), then all 4 (LR), every rank on
    the one card. Returns the unsharded runs and the ranks' results by
    world size."""
    plain = {f"lr {alg}": mesh_drive(make_trainer(lr_ds, alg, DEV), MESH_LR_ROUNDS)
             for alg in ("fedsubavg", "fedavg")}
    plain["din fedsubavg"] = mesh_drive(make_trainer(din_ds, "fedsubavg", DEV),
                                        MESH_DIN_ROUNDS)
    lr_jobs = [dict(kind="trainer", label=f"lr {alg} {comb}", ds=lr_ds, alg=alg,
                    combine=comb, rounds=MESH_LR_ROUNDS, capture=comb == "union")
               for alg, comb in (("fedsubavg", "auto"), ("fedavg", "auto"),
                                 ("fedsubavg", "union"))]
    more = [dict(kind="trainer", label="din fedsubavg auto", ds=din_ds, alg="fedsubavg",
                 combine="auto", rounds=MESH_DIN_ROUNDS),
            dict(kind="steps", label="steps", ds=lstm_ds)]
    # one spawn of 4 gloo ranks: the 2-rank jobs on its first two, then the
    # LR jobs on all four; the 1-rank NCCL mesh in this process
    gloo = run_mesh(4, "gloo", [dict(job, world=2) for job in lr_jobs + more]
                    + [dict(job, world=4) for job in lr_jobs])
    ranks = {1: run_mesh_here(lr_jobs[:2]), **gloo}
    return plain, ranks


def check_mesh_trainer(ranks: list, label: str, want: dict) -> dict:
    """One trainer job on every rank against the unsharded run: K1 once per
    round and rank under psum, once per rank more under union (the
    partial, then one call per further rank); losses, train loss and
    parameters within 1e-5; every rank's parameters equal rank 0's."""
    world, r0 = len(ranks), ranks[0][label]
    (mode,) = r0["combine"].values()
    rounds = r0["rounds"]
    per_round = world if mode == "union" else 1
    launches = [r[label]["launches"] for r in ranks]
    check(launches == [per_round * rounds] * world,
          f"x{world} {label}: K1 launched {launches} times per rank in {rounds} rounds, "
          f"want {per_round * rounds} each")
    loss_err = max(abs(a - b) for a, b in zip(r0["loss"], want["loss"]))
    check(loss_err <= 1e-5, f"x{world} {label}: losses {loss_err} from the unsharded "
          "trainer's")
    check(abs(r0["train_loss"] - want["train_loss"]) <= 1e-5,
          f"x{world} {label}: train loss {r0['train_loss']} against {want['train_loss']}")
    params_err = params_diff(r0["params"], want["params"])
    check(params_close(r0["params"], want["params"], 1e-5),
          f"x{world} {label}: parameters {params_err} from the unsharded trainer's")
    spread = rank_spread(ranks, label)
    check(spread == 0.0, f"x{world} {label}: ranks differ by {spread}")
    ms, plain_ms = statistics.median(r0["ms"][2:]), statistics.median(want["ms"][2:])
    by_op = {}
    for c in r0["counters"].values():
        by_op[c["op"]] = by_op.get(c["op"], 0) + c["bytes"]
    print(f"  x{world} {label} ({mode}): loss err {loss_err:.3g}, params err "
          f"{params_err:.3g}, ranks equal bit for bit; K1 per rank {launches}; ms/round "
          f"(rank 0) {ms:.2f} against {plain_ms:.2f} unsharded; bytes per rank per round "
          f"by op {by_op}; AUC {r0['auc']:.5f} against {want['auc']:.5f}")
    return {"launches": launches, "ms": ms, "plain_ms": plain_ms}


def phase_mesh_lr(plain: dict, ranks: dict) -> dict:
    """[31]: LR through ``FederatedTrainer(mesh=...)`` at world sizes 1
    (NCCL), 2 and 4 (gloo on the card's tensors; the ranks share the one
    card), fedsubavg and fedavg (``auto``: psum at V x 1 f32), and
    fedsubavg with ``combine="union"``, 20 rounds each, against the
    unsharded trainer on the card."""
    out = {"launches": {}, "k1_calls": []}
    for world, rks in sorted(ranks.items()):
        for label in rks[0]:
            if label.startswith("lr "):
                alg = label.split()[1]
                res = check_mesh_trainer(rks, label, plain[f"lr {alg}"])
                out["launches"][f"x{world} {label[3:]}"] = res["launches"]
        if world == 2:
            out["k1_calls"] = rks[0]["lr fedsubavg union"]["k1_calls"]
    print("  (ranks sharing one card measure the machinery, not a speed-up; gloo's "
          "all-reduce and all-gather took the card's tensors directly on every rank)")
    return out


def phase_mesh_din(plain: dict, ranks: list) -> list:
    """[32]: DIN through ``FederatedTrainer(mesh=...)``, 2 ranks, 10 rounds;
    ``auto`` picks ``union`` at 63,001 x 18 f32 (4.5 MB): K1 twice per rank
    per round."""
    check(ranks[0]["din fedsubavg auto"]["combine"] == {"item_emb": "union"},
          f"DIN combine {ranks[0]['din fedsubavg auto']['combine']}")
    return check_mesh_trainer(ranks, "din fedsubavg auto", plain["din fedsubavg"])["launches"]


def phase_mesh_steps(ranks: list) -> tuple:
    """[33]: ``make_round_step`` on the mesh, two ranks, each mode of
    ``MESH_STEP_MODES`` against its unsharded step on the card; every
    rank's collective counters equal the budget's components. Returns K1's
    launches by mode and rank, and every rank's comm drift by mode ([63])."""
    out, drift = {}, {}
    for label, mode, stacked, k, debug in MESH_STEP_MODES:
        r0 = ranks[0]["steps"][label]
        want = 1 if mode == "sparse_replicated" else 0
        for r, rk in enumerate(ranks):
            res = rk["steps"][label]
            check(res["launches"] == [want] * 3,
                  f"{label}: rank {r} K1 {res['launches']}, want {want} per step")
            check(all(res["counters_equal_budget"]),
                  f"{label}: rank {r} collective counters differ from the budget")
        loss_err = max(abs(a - b) for a, b in zip(r0["loss"], r0["plain_loss"]))
        check(loss_err <= 1e-5, f"{label}: losses {loss_err} from the unsharded step's")
        check(params_close(r0["params"], r0["plain_params"], 1e-5),
              f"{label}: parameters {params_diff(r0['params'], r0['plain_params'])} apart")
        spread = max(params_diff(rk["steps"][label]["params"], r0["params"]) for rk in ranks)
        check(spread == 0.0, f"{label}: ranks differ by {spread}")
        out[label] = [rk["steps"][label]["launches"] for rk in ranks]
        if "drift" in r0:
            drift[label] = [rk["steps"][label]["drift"] for rk in ranks]
        print(f"  {label}: loss err {loss_err:.3g}, params err "
              f"{params_diff(r0['params'], r0['plain_params']):.3g}, ranks equal; K1 per "
              f"rank per step {out[label]}; counters = budget on every rank; bytes per "
              f"rank by op {r0['by_op']}; ms/step (rank 0) {[round(x, 1) for x in r0['ms']]}")
    return out, drift


# ---------------------------------------------------------------------------
# [34]-[38]: federated LLM training
# ---------------------------------------------------------------------------

LM_ARCH = "qwen2_5_14b"
LM_LAYERS = 4
#: examples/federated_llm.py's corpus and cohort (``train``'s corpus takes 4
#: samples per client)
LM_CORPUS = dict(clients=256, seq=128, zipf_a=1.3, cohort=16)
LM_LR, LM_ROUNDS = 0.05, 10
LM_REDUCED = ("layers 48 -> 4: 4 layers at full width are 2.66 B f32 parameters "
              "(10.6 GB); parameters, gradients, the update and the new parameters "
              "take ~43 GB of the card's 80, and 48 layers would need ~470 GB")
#: [35]'s plans: FedSgdLocal on the dense and on the row-sparse transport
LM_PLANS = (("fedsubavg dense", "fedsubavg", False), ("fedavg dense", "fedavg", False),
            ("fedsubavg sparse", "fedsubavg", True), ("fedavg sparse", "fedavg", True))
#: card against host at full width ([36]): the sum order of 5,120- and
#: 13,824-long f32 dot products, as [11], and of the 2,048- and 32-token
#: gradient sums; the update scales a gradient by up to N / n_m = 256
LM_HOST_TOL = 1e-4
#: [36]'s update, leaf by leaf: ||(p_card - p0) - (p_host - p0)|| /
#: ||p_host - p0||. Each side rounds p0 + update to f32, an ulp of p0 apart
#: at most, which is large against an update far below p0; a gradient that
#: is zero or lost reads 1 and a wrong one about 1 or more
LM_UPDATE_TOL = 1e-3
#: card against host at the tiny scale ([37]): the repository's 1e-5
LM_STEP_TOL = 1e-5
LM_STEP_MODES = ("fedsgd", "sparse", "replicated", "sparse_replicated")
LM_TRAIN_SHAPE = (LM_CORPUS["cohort"], LM_CORPUS["seq"])
LM_COUNTED = (("flash_attention", flash_attention), ("flash_attention_bwd", flash_attention_bwd),
              ("union_segsum", union_segsum))


def lm_counts() -> dict:
    return {name: w.launches for name, w in LM_COUNTED}


def lm_zero_counts() -> None:
    for _, w in LM_COUNTED:
        w.launches = 0


def lm_config(layers: int = LM_LAYERS, **over):
    return get_config(LM_ARCH).replace(num_layers=layers, dtype="float32", **over)


def lm_params(cfg, device) -> tuple:
    """The flat training dict and its axes (any family), drawn from seed
    ``SEED``."""
    model = build_model(cfg).init(torch.Generator(device=device).manual_seed(SEED), device)
    return transformer.train_params(model)


def compare_grads(name, got, want, dtype) -> float:
    return max(compare(f"{name}.{g}", a.float(), w.float(), dtype)
               for g, a, w in zip(("dq", "dk", "dv"), got, want))


def compare_lse(name, got, want, dtype) -> float:
    """K3's log-sum-exp against the plain version's: +inf on the same rows
    (those with no valid key), the rest held to ``TOL``."""
    torch.cuda.synchronize()
    inf = torch.isinf(want)
    check(bool((torch.isinf(got) == inf).all()) and bool((got[inf] > 0).all()),
          f"{name}: +inf rows differ from the plain version's")
    return compare(name, got[~inf], want[~inf], dtype)


#: [34]'s cases: (name, B, Sq, Sk, H, KV, hd, causal, window, q_offset, dtype,
#: factor on q); the training shape first, then ragged, windowed,
#: continuation, non-causal and GQA groups above 8 (a block loops over the
#: group's heads: 11 of them in a cluster of 1 at "group 11", of 2 at
#: "group 22"). "train q x8": q scaled by 8, so the logits are 8 times
#: larger and the softmax sharp, and the 3xTF32 split's small terms carry
#: the result; its output, log-sum-exp and gradient are held elementwise
#: against their exact values (``compare_sharp``; the forward's from
#: ``attention_f64``); "no valid key": rows 103-127 see no key (its output
#: there is the mean of V over masked keys in the reference and not
#: compared; its log-sum-exp is +inf and its gradient 0)
K3_BWD_CASES = (("train", 16, 128, 128, 40, 8, 128, True, 0, 0, "f32", 1.0),
                ("train", 16, 128, 128, 40, 8, 128, True, 0, 0, "bf16", 1.0),
                ("train q x8", 16, 128, 128, 40, 8, 128, True, 0, 0, "f32", 8.0),
                ("ragged", 2, 100, 100, 8, 2, 64, True, 0, 0, "f32", 1.0),
                ("ragged", 2, 100, 100, 8, 2, 64, True, 0, 0, "bf16", 1.0),
                ("window", 2, 300, 300, 8, 2, 128, True, 70, 0, "f32", 1.0),
                ("window", 2, 300, 300, 8, 2, 128, True, 70, 0, "bf16", 1.0),
                ("continue", 2, 77, 200, 8, 2, 32, True, 0, 123, "f32", 1.0),
                ("non-causal", 1, 90, 150, 4, 4, 16, False, 0, 0, "f32", 1.0),
                ("window-nc", 1, 128, 128, 4, 2, 64, False, 40, 0, "bf16", 1.0),
                ("group 11", 2, 128, 128, 22, 2, 64, True, 0, 0, "f32", 1.0),
                ("group 11", 2, 128, 128, 22, 2, 64, True, 0, 0, "bf16", 1.0),
                ("group 22", 1, 100, 100, 22, 1, 128, True, 0, 0, "f32", 1.0),
                ("group 22", 1, 100, 100, 22, 1, 128, True, 0, 0, "bf16", 1.0),
                ("no valid key", 1, 128, 64, 4, 2, 64, False, 40, 0, "f32", 1.0),
                ("no valid key", 1, 128, 64, 4, 2, 64, False, 40, 0, "bf16", 1.0))
#: [34]'s run-to-run check: two backward calls bit for bit; at the window
#: the second call is given no log-sum-exp, so the wrapper runs K3 for it
K3_BWD_REPEAT = ("train", "window")


def compare_sharp(name, got, plain, exact, parts=("dq", "dk", "dv")) -> float:
    """The sharp-softmax case, elementwise against ``exact``, the plain
    version evaluated in f64 on the same inputs. There the plain version's
    own f32 evaluation (``plain``) is further than 2e-5 + 2e-5 |exact| from
    ``exact`` on thousands of gradient elements (each score's f32 rounding,
    8 times larger, moves P), so no f32 kernel can be held to 2e-5 of it;
    its output sits ~2e-5 from ``exact``, and the 3xTF32 forward's as far
    from it on the other side. The kernel is held to be, part by part, no
    further from ``exact`` than the plain version's f32 evaluation is: in its
    largest error and in its count of elements outside 2e-5 + 2e-5 |exact|.
    Both readings are printed, and the kernel's against ``plain`` beside
    them."""
    torch.cuda.synchronize()
    tol = TOL[torch.float32]
    worst = 0.0
    for g, a, p, x in zip(parts, got, plain, exact):
        a, p = a.double(), p.double()
        bound = tol * (1 + x.abs())
        e_k, e_p, e_kp = (a - x).abs(), (p - x).abs(), (a - p).abs()
        k_max, p_max = float(e_k.max()), float(e_p.max())
        k_out, p_out = int((e_k > bound).sum()), int((e_p > bound).sum())
        kp_out = int((e_kp > tol * (1 + p.abs())).sum())
        worst = max(worst, k_max)
        print(f"    {name}.{g} against its exact value: kernel max abs err {k_max:.3g}, "
              f"{k_out} outside {tol:g} + {tol:g} |exact|; the plain version in f32 "
              f"{p_max:.3g}, {p_out} outside; kernel against the f32 plain version "
              f"{float(e_kp.max()):.3g}, {kp_out} outside")
        check(k_max <= p_max and k_out <= p_out,
              f"{name}.{g}: further from its exact value than the plain version's f32 "
              f"evaluation (max {k_max} against {p_max}, {k_out} against {p_out} outside)")
    return worst


def attention_f64(q, k, v, *, causal, window, q_offset) -> tuple:
    """K3's function in f64, unchunked: ``(o, lse)`` of the softmax of q
    k^T * scale over each row's valid keys (the reference's scale, rounded
    to f32 first), for rows with at least one; the exact values the sharp
    case holds the kernel and the f32 plain version to."""
    h, kvh, hd = q.shape[2], k.shape[2], q.shape[3]
    heads = lambda x, n: x.double().transpose(1, 2).repeat_interleave(n, dim=1)  # noqa: E731
    s = heads(q, 1) @ heads(k, h // kvh).transpose(-1, -2) * float(np.float32(hd) ** -0.5)
    qpos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = torch.ones_like(qpos + kpos, dtype=torch.bool)
    if causal:
        valid &= kpos <= qpos
    if window > 0:
        valid &= kpos > qpos - window
    s = s.masked_fill(~valid, -torch.inf)
    return ((torch.softmax(s, dim=-1) @ heads(v, h // kvh)).transpose(1, 2),
            torch.logsumexp(s, dim=-1))


def phase_k3_bwd(rng) -> tuple:
    """[34] K3 (output and log-sum-exp) and its backward on that log-sum-exp
    against their plain versions, case by case (tolerance by dtype), two
    backward calls bit for bit, and ``FlashAttention`` under
    ``torch.func.grad`` and ``vmap`` against autograd of K3's plain version.
    Returns the worst forward and the worst backward error."""
    from torch.func import grad, vmap

    bf, f32 = torch.bfloat16, torch.float32
    worst = worst_fwd = 0.0
    for (name, b, sq, sk, h, kv, hd, causal, window, off, dname,
         scale) in K3_BWD_CASES:
        dtype = f32 if dname == "f32" else bf
        q, k, v = (normal(rng, shape, f32).to(dtype)
                   for shape in ((b, sq, h, hd), (b, sk, kv, hd), (b, sk, kv, hd)))
        q = (q.float() * scale).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        # the backward below takes the kernel's output and log-sum-exp: the
        # forward is held to its plain version first, so a wrong ``o`` or
        # ``lse`` cannot pass unseen
        o, lse = flash_attention(q, k, v, **kw, return_lse=True)
        o_plain, lse_plain = flash_attention_torch(q, k, v, **kw, return_lse=True)
        if scale != 1:
            check(not bool(torch.isinf(lse).any() or torch.isinf(lse_plain).any()),
                  f"[34] {name}: a row without a valid key")
            err_l = err_f = compare_sharp(f"flash_attention[{name}]", (o, lse),
                                          (o_plain, lse_plain),
                                          attention_f64(q, k, v, **kw), parts=("o", "lse"))
        else:
            err_l = compare_lse(f"flash_attention lse[{name}]", lse, lse_plain, dtype)
            err_f = err_l
        if name == "no valid key":
            check(bool(torch.isinf(lse_plain).any()), "[34]: no row without a valid key")
        elif scale == 1:
            err_f = max(err_f, compare(f"flash_attention[{name}]", o, o_plain, dtype))
        worst_fwd = max(worst_fwd, err_f)
        do = normal(rng, o.shape, dtype)
        got = flash_attention_bwd(q, k, v, o, do, **kw, lse=lse)
        want = flash_attention_bwd_torch(q, k, v, o, do, **kw)
        if scale != 1:
            exact = flash_attention_bwd_torch(*(x.double() for x in (q, k, v, o, do)), **kw)
            err = compare_sharp(f"flash_attention_bwd[{name}]", got, want, exact)
            del exact
        else:
            err = compare_grads(f"flash_attention_bwd[{name}]", got, want, dtype)
        worst = max(worst, err)
        same = ""
        if name in K3_BWD_REPEAT:
            again = flash_attention_bwd(q, k, v, o, do, **kw,
                                        **({} if name == "window" else {"lse": lse}))
            torch.cuda.synchronize()
            check(all(a.equal(g) for a, g in zip(again, got)),
                  f"flash_attention_bwd[{name}]: two calls differ")
            same = "; two calls bit for bit" + (" (the second without lse)"
                                                if name == "window" else "")
        print(f"  K3 and backward {name:12s} {str(dtype):14s} B={b} Sq={sq} Sk={sk} H={h} "
              f"KV={kv} hd={hd} causal={causal} window={window} q_offset={off}"
              f"{f' q x{scale:g}' if scale != 1 else ''} max_abs_err forward "
              f"{err_f:.3g} (lse {err_l:.3g}), backward {err:.3g}{same}")

    # FlashAttention through torch.func against autograd of the plain forward
    n, b, s, h, kv, hd = 3, 2, 128, 8, 2, 64
    for dtype in (f32, bf):
        q, k, v = (normal(rng, (n, b, s, h, hd), dtype), normal(rng, (n, b, s, kv, hd), dtype),
                   normal(rng, (n, b, s, kv, hd), dtype))
        w = normal(rng, (b, s, h, hd), dtype)
        fused = lambda q, k, v: (  # noqa: E731
            FlashAttention.apply(q, k, v, True, 0, 0, 1024, 1024)[0] * w).float().sum()

        def plain_grads(i):
            leaves = [t[i].clone().requires_grad_() for t in (q, k, v)]
            out = (flash_attention_torch(*leaves) * w).float().sum()
            return torch.autograd.grad(out, leaves)

        g_fn = grad(fused, argnums=(0, 1, 2))
        before = flash_attention_bwd.launches
        got = g_fn(q[0], k[0], v[0])
        torch.cuda.synchronize()
        check(flash_attention_bwd.launches == before + 1, "grad did not launch K3's backward")
        err = compare_grads(f"FlashAttention grad {dtype}", got, plain_grads(0), dtype)
        before = flash_attention_bwd.launches
        got = vmap(g_fn)(q, k, v)
        torch.cuda.synchronize()
        check(flash_attention_bwd.launches == before + 1,
              "vmap(grad) did not fold the clients into one K3 backward launch")
        for i in range(n):
            err = max(err, compare_grads(f"FlashAttention vmap(grad)[{i}] {dtype}",
                                         tuple(g[i] for g in got), plain_grads(i), dtype))
        worst = max(worst, err)
        print(f"  FlashAttention {str(dtype):14s} under grad and vmap(grad) over {n} "
              f"clients (B={b} S={s} H={h} KV={kv} hd={hd}) against autograd of the plain "
              f"forward: max_abs_err={err:.3g}; one launch per call")
    return worst_fwd, worst


def phase_lm_main() -> dict:
    """[35] the main path: ``launch.train.train`` at Qwen2.5-14B's widths,
    4 layers, f32, 10 rounds per plan, each from the seed's weights, with
    every count set to 0 just before it and read just after."""
    cfg = lm_config()
    runs = {}
    for label, alg, sparse in LM_PLANS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm_zero_counts()
        # the weights from seed 0 (``SEED``), drawn by ``train`` itself, so
        # that no second copy of them stays alive through the run
        res = train_mod.train(cfg, rounds=LM_ROUNDS, lr=LM_LR, algorithm=alg,
                              sparse=sparse, device=DEV, log_every=0, remat=False,
                              **LM_CORPUS)
        launches = lm_counts()
        peak = torch.cuda.max_memory_allocated()
        if not runs:
            n_params = sum(p.numel() for p in res.params.values())
            print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
                  f"{n_params / 1e9:.3f} B params ({cfg.dtype}); reduced: {LM_REDUCED}")
        check(all(math.isfinite(x) for x in res.losses), f"{label}: a loss is not finite")
        nl = cfg.num_layers * LM_ROUNDS
        check(launches == {"flash_attention": nl, "flash_attention_bwd": nl,
                           "union_segsum": 0},
              f"{label}: launches {launches}, want {cfg.num_layers} of K3 and of its "
              "backward per round and no K1 (FedSgdLocal)")
        steady = statistics.median(res.ms_per_round[1:])
        runs[label] = {"losses": res.losses, "ms_per_round": res.ms_per_round,
                       "steady_ms_per_round": steady, "peak_gb": peak / 1e9,
                       "launches": launches, "bytes_up_sparse": res.bytes_up_sparse,
                       "bytes_up_dense": res.bytes_up_dense}
        print(f"  {label} ({res.plan}): loss {[round(x, 4) for x in res.losses]}")
        print(f"    ms/round: first {res.ms_per_round[0]:.1f}, steady {steady:.1f} (median "
              f"of rounds 2-{LM_ROUNDS}); peak device memory {peak / 1e9:.2f} GB; "
              f"launches {launches}")
        if res.bytes_up_sparse:
            print(f"    uplink per round (cohort as one union): "
                  f"{[round(x / 1e6, 2) for x in res.bytes_up_sparse]} MB sparse against "
                  f"{res.bytes_up_dense[-1] / 1e6:.1f} MB dense")
        del res
    return runs


def phase_lm_card_vs_host() -> dict:
    """[36] one round per transport at full width, 1 layer, cohort 2,
    32 tokens, on the card and on the host from the same weights: the loss,
    the parameters, and each leaf's update (parameters after minus before),
    which the parameters' own tolerance cannot see when it is small."""
    cfg = lm_config(1)
    out = {}
    for label, sparse in (("dense", False), ("sparse", True)):
        card, axes = lm_params(cfg, DEV)
        # the round updates sparse tables in place: p0 stays untouched
        p0 = {k: v.to("cpu", copy=True) for k, v in card.items()}
        host = {k: v.clone() for k, v in p0.items()}
        kw = dict(rounds=1, lr=LM_LR, sparse=sparse, axes=axes, log_every=0, remat=False,
                  **{**LM_CORPUS, "cohort": 2, "seq": 32})
        lm_zero_counts()
        rc = train_mod.train(cfg, device=DEV, params=card, **kw)
        check(lm_counts() == {"flash_attention": 1, "flash_attention_bwd": 1,
                              "union_segsum": 0}, f"card run launches {lm_counts()}")
        del card
        t0 = time.perf_counter()
        rh = train_mod.train(cfg, device="cpu", params=host, **kw)
        host_s = time.perf_counter() - t0
        check(lm_counts()["flash_attention"] == 1, "the host run launched a kernel")
        loss_err = abs(rc.losses[0] - rh.losses[0])
        check(loss_err <= LM_HOST_TOL * max(1.0, abs(rh.losses[0])),
              f"{label}: card and host losses differ by {loss_err}")
        err, upd = 0.0, {}
        # compared on the card: the same f32 arithmetic, and the (152,064,
        # 5,120) tables take seconds per elementwise pass on the host
        for name, want in rh.params.items():
            got, want, before = rc.params[name], want.to(DEV), p0[name].to(DEV)
            diff = float((got - want).abs().max())
            err = max(err, diff)
            check(torch.allclose(got, want, rtol=LM_HOST_TOL, atol=LM_HOST_TOL),
                  f"{label}: {name} differs between card and host by {diff}")
            d_host, d_card = want - before, got - before
            norm = float(torch.linalg.vector_norm(d_host))
            rel = (float(torch.linalg.vector_norm(d_card - d_host)) / norm if norm
                   else (0.0 if not d_card.any() else math.inf))
            upd[name] = (rel, float(d_host.abs().max()))
            check(rel <= LM_UPDATE_TOL, f"{label}: {name}'s update differs between card and "
                  f"host by {rel:.3g} of its norm (largest update {upd[name][1]:.3g})")
        worst = max(upd, key=lambda n: upd[n][0])
        out[label] = {"loss_diff": loss_err, "param_diff": err,
                      "update_rel_diff": {n: r for n, (r, _) in upd.items()},
                      "update_max_abs": {n: m for n, (_, m) in upd.items()}}
        print(f"  {label}: loss card {rc.losses[0]:.6f} host {rh.losses[0]:.6f} "
              f"(|diff| {loss_err:.3g}); max |param diff| {err:.3g} (tolerance "
              f"{LM_HOST_TOL}); host round {host_s:.1f} s")
        print(f"    update card against host, ||d_card - d_host|| / ||d_host|| by leaf "
              f"(tolerance {LM_UPDATE_TOL}; a zero gradient reads 1): worst {upd[worst][0]:.3g} "
              f"({worst})")
        for name, (rel, big) in upd.items():
            if name.startswith("layers.0.attn") or not name.startswith("layers."):
                print(f"      {name:28s} rel {rel:.3g}, largest |update| {big:.3g}")
        del rc, rh, host, p0
    return out


def lm_step_batches(ds, cohort: int, steps: int, stacked: bool, local_iters: int = 2):
    """``steps`` numpy batches from ``ds``: flat ``(cohort * 4, S)`` pooled
    sequences, or ``(cohort, local_iters, 2, S)`` per-client stacks, each with
    ``heat_vocab``."""
    rng = np.random.default_rng(SEED)
    toks = ds.client_data["tokens"]
    out = []
    for _ in range(steps):
        ids = rng.choice(ds.num_clients, size=cohort, replace=False)
        t = toks[ids]                                        # (K, 4, S)
        t = t.reshape(cohort, local_iters, -1, t.shape[-1]) if stacked else t.reshape(
            -1, t.shape[-1])
        out.append({"tokens": t, "heat_vocab": ds.heat.counts.astype(np.float32)})
    return out


def run_lm_steps(cfg, mode: str, device, batches, clients: int, cohort: int, params,
                 axes) -> tuple:
    """``make_round_step`` in ``mode`` over ``batches`` from ``params`` on
    ``device``; returns losses, ms per step, final parameters and the
    launches, counted from 0."""
    api = build_model(cfg)
    fed = FedConfig(num_clients=clients, clients_per_round=cohort, local_iters=2, lr=LM_LR,
                    algorithm="fedsubavg")
    step = make_round_step(api.loss, params, axes, fed, mode=mode)
    losses, ms = [], []
    lm_zero_counts()
    for b in batches:
        t0 = time.perf_counter()
        params, m = step(params, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, params, lm_counts()


def phase_lm_round_steps() -> dict:
    """[37] ``make_round_step`` at the reference's ``100m`` scale in its four
    modes, K1 counted per step and held to its plain version on the
    ``sparse_replicated`` step's inputs; the same at ``tiny`` on the card and
    on the host."""
    steps, cohort, clients = 3, 4, 64
    out = {}
    for scale in ("100m", "tiny"):
        cfg = get_config(LM_ARCH).replace(**serve_mod.SCALES[scale])
        ds = make_lm_federated(num_clients=clients, vocab=cfg.vocab_size, seq_len=128,
                               samples_per_client=4, zipf_a=LM_CORPUS["zipf_a"])
        for mode in LM_STEP_MODES:
            batches = lm_step_batches(ds, cohort, steps, "replicated" in mode)
            init, axes = lm_params(cfg, DEV)
            host_init = {k: v.to("cpu", copy=True) for k, v in init.items()}
            captured = {}
            ctx = (capture_k1(captured) if mode == "sparse_replicated"
                   else contextlib.nullcontext())
            with ctx:
                losses, ms, params, launches = run_lm_steps(cfg, mode, DEV, batches, clients,
                                                            cohort, init, axes)
            del init
            if captured:
                args = captured["args"]
                ids, rows, v = args[0], args[1], args[5]
                union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
                err = check_k1(f"union_segsum[lm {scale} sparse_replicated step]", args,
                               captured["kw"]["scale"], union)
                out["k1_err"] = max(out.get("k1_err", 0.0), err)
                print(f"  K1 at a {scale} sparse_replicated step: V={v} T={ids.numel()} "
                      f"D={rows.shape[-1]} cap={args[4]} union={union} max_abs_err={err:.3g}")
            check(all(math.isfinite(x) for x in losses), f"{scale} {mode}: loss not finite")
            want_k1 = steps if mode == "sparse_replicated" else 0
            check(launches["union_segsum"] == want_k1,
                  f"{scale} {mode}: K1 launched {launches['union_segsum']} times in {steps} "
                  f"steps, want {want_k1}")
            check(launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0,
                  f"{scale} {mode}: K3 or its backward did not launch: {launches}")
            line = (f"  {scale} {mode:17s}: loss {[round(x, 4) for x in losses]}, ms/step "
                    f"{[round(x, 1) for x in ms]}, launches {launches}")
            if scale == "tiny":
                h_losses, _, h_params, h_launches = run_lm_steps(cfg, mode, "cpu", batches,
                                                                 clients, cohort, host_init,
                                                                 axes)
                check(sum(h_launches.values()) == 0, "the host run launched a kernel")
                err = max(float((params[k].cpu() - h_params[k]).abs().max())
                          for k in h_params)
                check(np.allclose(losses, h_losses, rtol=LM_STEP_TOL, atol=LM_STEP_TOL),
                      f"tiny {mode}: card losses {losses} against host {h_losses}")
                check(all(torch.allclose(params[k].cpu(), h_params[k], rtol=LM_STEP_TOL,
                                         atol=LM_STEP_TOL) for k in h_params),
                      f"tiny {mode}: card and host parameters differ by {err}")
                line += f"; card against host: max |param diff| {err:.3g}"
                out[f"tiny {mode} param_diff"] = err
            out[f"{scale} {mode}"] = launches
            print(line)
            del params
    return out


def phase_lm_profile(steady_ms: float, err_bwd: float, launches_bwd: int,
                     k3: dict) -> dict:
    """[38] where one fedsubavg dense round of [35]'s path goes (device ops,
    busy share of [35]'s steady round, device ms by kind), then K3 and its
    backward at the training shape, each first held to its plain version
    there, then timed by CUDA events beside their plain versions, SDPA (its
    backward: autograd of ``scaled_dot_product_attention``, its forward
    subtracted) and the bound. Returns K3-backward's entry and adds K3's
    training-shape times and error to ``k3``."""
    cfg = lm_config()
    api = build_model(cfg)
    params, axes = lm_params(cfg, DEV)
    k = LM_CORPUS["cohort"]
    ds = make_lm_federated(num_clients=LM_CORPUS["clients"], vocab=cfg.vocab_size,
                           seq_len=LM_CORPUS["seq"], zipf_a=LM_CORPUS["zipf_a"],
                           samples_per_client=4)
    fed = FedConfig(num_clients=ds.num_clients, clients_per_round=k, lr=LM_LR,
                    algorithm="fedsubavg")
    step = make_round_step(lambda p, b: api.loss(p, b, remat=False), params, axes, fed,
                           mode=train_mod.make_plan())
    rng = np.random.default_rng(SEED)
    toks = ds.client_data["tokens"]
    ids = rng.choice(ds.num_clients, size=k, replace=False)
    batch = {"tokens": torch.from_numpy(toks[ids, rng.integers(0, toks.shape[1], k)]).to(DEV),
             "heat_vocab": torch.as_tensor(ds.heat.counts, dtype=torch.float32).to(DEV)}
    state = {"params": params}
    del params

    def one_round():
        state["params"], m = step(state["params"], batch)
        float(m["loss"])

    one_round()
    _, by_name, ops = device_profile(one_round)
    device_ms = sum(by_name.values()) / 1e3
    kinds = {"K3": ("attention_kernel",), "K3 backward": ("dq_kernel", "dkv_kernel")}
    split = {kind: sum(t for name, t in by_name.items() if any(w in name for w in ws)) / 1e3
             for kind, ws in kinds.items()}
    split["matmuls"] = matmul_us(by_name) / 1e3
    split["elementwise and the rest"] = device_ms - sum(split.values())
    # cuBLAS's share: forward and backward (2 + 4 flops a weight a token) of
    # every 2-D weight but the embedding, which is gathered, not multiplied
    mm_flops = 6 * batch["tokens"].numel() * sum(
        p.numel() for name, p in state["params"].items() if p.dim() == 2 and name != "embedding")
    del state
    print(f"  fedsubavg dense round: {steady_ms:.1f} ms steady ([35]); {ops} device ops, "
          f"{device_ms:.2f} ms busy ({device_ms / steady_ms * 100:.1f}%): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    print(f"  matmuls: {mm_flops / 1e12:.2f} TFLOP per round from the shapes, "
          f"{mm_flops / split['matmuls'] / 1e9:.1f} TFLOP/s (f32 without TF32; "
          f"{HW['peak_flops_f32'] / 1e12:.0f} TFLOP/s peak)")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {t / 1e3:.4f} ms  {name[:90]}")

    fwd, bwd = train_attention_timing((*LM_TRAIN_SHAPE, cfg.num_heads, cfg.num_kv_heads,
                                       cfg.head_dim), SEED + 34, "training round shape")
    k3["max_abs_err"] = max(k3["max_abs_err"], fwd["max_abs_err"])
    k3["training"] = {**fwd, "launches_main_path": k3["launches_by_path"]["training"],
                      "device_ms_per_round": split["K3"]}
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:154",
            "launches": launches_bwd, **bwd, "max_abs_err": max(err_bwd, bwd["max_abs_err"]),
            "device_ms_per_round": split["K3 backward"],
            "round_split_ms": split, "round_device_ops": ops,
            "round_matmul_tflop": mm_flops / 1e12}


def train_attention_timing(shape, seed: int, label: str, sk: int | None = None,
                           causal: bool = True) -> tuple:
    """K3 and its backward at a training shape ``(B, S, H, KV, hd)``, f32,
    causal (or, with ``causal=False``, not; ``sk`` keys where it is given),
    on random inputs from ``seed``: each first held to its plain version
    there, then timed by CUDA events beside their plain versions, SDPA (its
    backward: autograd of ``scaled_dot_product_attention``, its forward
    subtracted) and the bound. Returns K3's and its backward's numbers."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    b, s, h, kvh, hd = shape
    sk = s if sk is None else sk
    dtype = torch.float32
    q, k, v = normal(rng, (b, s, h, hd), dtype), normal(rng, (b, sk, kvh, hd), dtype), normal(
        rng, (b, sk, kvh, hd), dtype)
    o, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    o_plain, lse_plain = flash_attention_torch(q, k, v, causal=causal, return_lse=True)
    err_fwd = max(compare(f"flash_attention[{label}]", o, o_plain, dtype),
                  compare_lse(f"flash_attention lse[{label}]", lse, lse_plain, dtype))
    del o_plain, lse_plain
    do = normal(rng, o.shape, dtype)
    err_bwd = compare_grads(f"flash_attention_bwd[{label}]",
                            flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse),
                            flash_attention_bwd_torch(q, k, v, o, do, causal=causal), dtype)
    qt = q.transpose(1, 2).contiguous().requires_grad_()
    kt = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous().requires_grad_()
    vt = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous().requires_grad_()
    dot = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)  # noqa: E731

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

    fwd = lambda: flash_attention(q, k, v, causal=causal)                   # noqa: E731
    fwd_plain = lambda: flash_attention_torch(q, k, v, causal=causal)       # noqa: E731
    bwd = lambda: flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)  # noqa: E731
    bwd_plain = lambda: flash_attention_bwd_torch(q, k, v, o, do, causal=causal)  # noqa: E731
    with torch.no_grad():
        f_p1, f1, f2, f_p2 = (cuda_ms(fwd_plain, 5, 1), cuda_ms(fwd, 20), cuda_ms(fwd, 20),
                              cuda_ms(fwd_plain, 5, 1))
        f_lib = cuda_ms(sdpa, 20)
    b_p1, b1, b2, b_p2 = (cuda_ms(bwd_plain, 5, 1), cuda_ms(bwd, 20), cuda_ms(bwd, 20),
                          cuda_ms(bwd_plain, 5, 1))
    b_lib = cuda_ms(sdpa_fwd_bwd, 20) - f_lib
    pairs = s * (s + 1) // 2 if causal else s * sk
    work = dict(b=b, sq=s, h=h, kv=kvh, hd=hd, keys=sk, pairs=pairs, dtype=dtype)
    cf, cb = cost_model("flash_attention", **work), cost_model("flash_attention_bwd", **work)
    f_bound, f_by = cf.bound_ms, cf.bound_by
    # the forward's route: each of its 2 products as 3 TF32 products
    f_route, f_route_by = cf.extra["route_ms"], cf.extra["route_by"]
    # the gradient: twice the forward's bytes and the lse, 2.5 times its
    # flops; its route runs each product as 3 TF32 products (cost_model)
    b_bytes, b_ops, b_bound, b_by = cb.bytes, cb.flops, cb.bound_ms, cb.bound_by
    b_route, b_route_by = cb.extra["route_ms"], cb.extra["route_by"]
    mask = "causal" if causal else "non-causal"
    print(f"  K3 at the {label} B={b} S={s}{f' Sk={sk}' if sk != s else ''} H={h} KV={kvh} "
          f"hd={hd} {dtype} {mask}: "
          f"max_abs_err {err_fwd:.3g}; kernel {f1:.4f}/{f2:.4f} ms "
          f"({cf.flops / min(f1, f2) / 1e9:.1f} TFLOP/s on its 2 products), plain {f_p1:.4f}/"
          f"{f_p2:.4f} ms, SDPA {f_lib:.4f} ms; bound {f_route:.5f} ms on its route "
          f"({f_route_by}; 3xTF32, {cf.bytes / 1e6:.1f} MB), {f_bound:.5f} ms on the f32 "
          f"CUDA cores ({f_by})")
    print(f"  K3 backward: max_abs_err {err_bwd:.3g}; kernel {b1:.4f}/{b2:.4f} ms "
          f"({b_ops / min(b1, b2) / 1e9:.1f} TFLOP/s on its 5 products), plain {b_p1:.4f}/"
          f"{b_p2:.4f} ms, SDPA backward {b_lib:.4f} ms; bound {b_route:.5f} ms on its route "
          f"({b_route_by}; 3xTF32 at {HW['peak_flops_tf32'] / 3e12:.0f} TFLOP/s effective, "
          f"{b_bytes / 1e6:.1f} MB at {HW['hbm_bandwidth'] / 1e12:.2f} TB/s), {b_bound:.5f} ms "
          f"on the f32 CUDA cores ({b_by}; {cb.peak / 1e12:.0f} TFLOP/s)")
    shape_key = {"shape": [b, s, h, kvh, hd]}
    if sk != s or not causal:
        shape_key.update(sk=sk, causal=causal)
    return ({**shape_key, "dtype": "float32", "ms": min(f1, f2),
             "plain_ms": min(f_p1, f_p2), "library_ms": f_lib, "bound_ms": f_bound,
             "bound_by": f_by, "bound_ms_route": f_route, "bound_by_route": f_route_by,
             "max_abs_err": err_fwd},
            {**shape_key, "max_abs_err": err_bwd, "ms": min(b1, b2),
             "plain_ms": min(b_p1, b_p2), "bound_ms": b_bound, "bound_by": b_by,
             "bound_ms_route": b_route, "bound_by_route": b_route_by, "library_ms": b_lib})


def phase_lm_training(kernels: list, rng, k1: dict) -> list:
    """[34]-[38], each timed; returns K3-backward's kernel entry (K3's gains
    its training numbers, K1's its launches on [37]'s steps)."""
    print("[34] K3 and its backward vs plain versions; FlashAttention under grad and vmap")
    t0 = time.perf_counter()
    k3 = next(e for e in kernels if e["name"] == "flash_attention")
    err_fwd, err_bwd = phase_k3_bwd(rng)
    k3["max_abs_err"] = max(k3["max_abs_err"], err_fwd)
    print(f"  [34] took {time.perf_counter() - t0:.1f} s")

    print(f"[35] federated LLM training: {LM_ARCH} at its published widths, {LM_LAYERS} "
          f"layers, f32, {LM_CORPUS}, {LM_ROUNDS} rounds per plan")
    t0 = time.perf_counter()
    lm_runs = phase_lm_main()
    print(f"  [35] took {time.perf_counter() - t0:.1f} s")

    print("[36] card vs host: 1 layer at full width, f32, cohort 2, 32 tokens, one round "
          "per transport")
    t0 = time.perf_counter()
    phase_lm_card_vs_host()
    print(f"  [36] took {time.perf_counter() - t0:.1f} s")

    print("[37] make_round_step on the LLM at the 100m scale in four modes; card vs host "
          "at the tiny scale")
    t0 = time.perf_counter()
    steps = phase_lm_round_steps()
    for mode in LM_STEP_MODES:
        k1["launches_by_path"][f"lm 100m make_round_step {mode}"] = steps[
            f"100m {mode}"]["union_segsum"]
    k1["max_abs_err"] = max(k1["max_abs_err"], steps["k1_err"])
    print(f"  [37] took {time.perf_counter() - t0:.1f} s")

    print("[38] where a training round's time goes; K3 and its backward at the training "
          "shape")
    t0 = time.perf_counter()
    k3["launches_by_path"] = {
        "serving prefill": k3["launches"],
        "training": sum(r["launches"]["flash_attention"] for r in lm_runs.values())}
    launches_bwd = sum(r["launches"]["flash_attention_bwd"] for r in lm_runs.values())
    entry = phase_lm_profile(lm_runs["fedsubavg dense"]["steady_ms_per_round"],
                             err_bwd, launches_bwd, k3)
    print(f"  [38] took {time.perf_counter() - t0:.1f} s")
    return [entry]


# ---------------------------------------------------------------------------
# [39]-[43]: Mixtral 8x22B's MoE and the other dense configurations
# ---------------------------------------------------------------------------

MOE_ARCH = "mixtral_8x22b"
MOE_SERVE_LAYERS = 8
MOE_SERVE_BATCH, MOE_SERVE_PROMPT, MOE_SERVE_GEN = 2, 8192, 32
MOE_SERVE_REDUCED = ("layers 56 -> 8: a layer holds 2.504 B bf16 parameters (5.01 GB); 8 "
                     "layers with the embedding and lm_head (0.81 GB) take ~40.9 GB of the "
                     "card's 80, and 56 would take ~281 GB")
MOE_TRAIN_ROUNDS = 5
MOE_TRAIN_REDUCED = ("layers 56 -> 1: 2.91 B f32 parameters (11.6 GB); with the gradients, "
                     "the update and the new parameters ~46 GB, and 2 layers would need "
                     "~86 GB")
#: [42]'s plans: FedSgdLocal under fedsubavg and fedavg on the dense transport,
#: fedsubavg on the row-sparse one
MOE_PLANS = LM_PLANS[:3]
#: [41]: serving at 1 full-width layer in f32, card against host (the sum
#: order of 6,144- and 16,384-long f32 dot products, as [11])
MOE_HOST_PROMPT, MOE_HOST_GEN, MOE_HOST_TOL = 256, 4, 1e-4
#: [43]: the dense configurations at their published widths, bf16, 2 layers
DENSE_ARCHS = ("qwen3_32b", "deepseek_67b", "mistral_large_123b")
DENSE_LAYERS = 2
DENSE_BATCH, DENSE_PROMPT, DENSE_GEN = 4, 1024, 8
#: [39]'s K3 cases at the new configurations' attention shapes: (name, B, S,
#: H, KV, window); hd 128 throughout. Qwen3-32B and DeepSeek-67B share
#: H 64, KV 8; Mixtral's window binds from position 4,096 on
NEW_K3_CASES = (("qwen3-32b, deepseek-67b", DENSE_BATCH, DENSE_PROMPT, 64, 8, 0),
                ("mistral-large-123b", DENSE_BATCH, DENSE_PROMPT, 96, 8, 0),
                ("mixtral-8x22b", MOE_SERVE_BATCH, MOE_SERVE_PROMPT, 48, 8, 4096))
#: [39]'s K4 cases: (name, B, H, KV, slots, positions written, window); the
#: dense caches full after a prompt and its steps, Mixtral's ring of 4,096
#: slots after 8,224 positions
NEW_K4_CASES = (("qwen3-32b, deepseek-67b", DENSE_BATCH, 64, 8, DENSE_PROMPT + DENSE_GEN,
                 DENSE_PROMPT + DENSE_GEN, 0),
                ("mistral-large-123b", DENSE_BATCH, 96, 8, DENSE_PROMPT + DENSE_GEN,
                 DENSE_PROMPT + DENSE_GEN, 0),
                ("mixtral-8x22b ring", MOE_SERVE_BATCH, 48, 8, 4096,
                 MOE_SERVE_PROMPT + MOE_SERVE_GEN, 4096))
#: [39]'s K3-backward cases, f32 at [38]'s B 16 x S 128: GQA groups of 6
#: (Mixtral's 48 / 8) and 12 (Mistral Large's 96 / 8)
NEW_BWD_CASES = (("group 6", 16, 128, 48, 8), ("group 12", 16, 128, 96, 8))
#: [42]'s tiny steps: the cohort's heat per expert, from seed 0 in [1, 256]
MOE_HEAT_RANGE = (1, 257)


def phase_new_shapes(rng) -> tuple:
    """[39] K3 and K4 against their plain versions at the new
    configurations' attention shapes, bf16 and f32, and K3's backward (f32)
    at GQA groups of 6 and 12. Returns the worst K3, K4 and backward
    errors."""
    worst = {"k3": 0.0, "k4": 0.0, "bwd": 0.0}
    hd = 128
    for name, b, s, h, kv, window in NEW_K3_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (normal(rng, (b, s, h, hd), dtype), normal(rng, (b, s, kv, hd), dtype),
                       normal(rng, (b, s, kv, hd), dtype))
            err = compare(f"flash_attention[{name}]", flash_attention(q, k, v, window=window),
                          flash_attention_torch(q, k, v, window=window), dtype)
            worst["k3"] = max(worst["k3"], err)
            print(f"  K3 {name:24s} {str(dtype):14s} B={b} S={s} H={h} KV={kv} hd={hd} "
                  f"window={window} max_abs_err={err:.3g}")
            del q, k, v
    for name, b, h, kv, slots, written, window in NEW_K4_CASES:
        kpos = cache_slot_positions(written, slots, window > 0, DEV)
        for dtype in (torch.bfloat16, torch.float32):
            q = normal(rng, (b, h, hd), dtype)
            kc, vc = normal(rng, (b, kv, slots, hd), dtype), normal(rng, (b, kv, slots, hd), dtype)
            got = flash_decode(q, kc, vc, kpos, written - 1, window=window)
            err = compare(f"flash_decode[{name}]", got.float(),
                          flash_decode_torch(q, kc, vc, kpos, written - 1,
                                             window=window).float(), dtype)
            worst["k4"] = max(worst["k4"], err)
            print(f"  K4 {name:24s} {str(dtype):14s} B={b} H={h} KV={kv} S={slots} hd={hd} "
                  f"q_position={written - 1} window={window} max_abs_err={err:.3g}")
    dtype = torch.float32
    for name, b, s, h, kv in NEW_BWD_CASES:
        q, k, v = (normal(rng, (b, s, h, hd), dtype), normal(rng, (b, s, kv, hd), dtype),
                   normal(rng, (b, s, kv, hd), dtype))
        o, lse = flash_attention(q, k, v, return_lse=True)
        do = normal(rng, o.shape, dtype)
        err = compare_grads(f"flash_attention_bwd[{name}]",
                            flash_attention_bwd(q, k, v, o, do, lse=lse),
                            flash_attention_bwd_torch(q, k, v, o, do), dtype)
        worst["bwd"] = max(worst["bwd"], err)
        print(f"  K3 backward {name:8s} {str(dtype):14s} B={b} S={s} H={h} KV={kv} hd={hd} "
              f"(cluster {bwd_cluster(h, kv)}) max_abs_err={err:.3g}")
    return worst["k3"], worst["k4"], worst["bwd"]


@contextlib.contextmanager
def record_moe(records: list, routing: bool = False):
    """Wrap ``layers.moe`` so that each call appends its ``expert_tokens``
    and, with ``routing``, where it sent each token (``layers.moe_route``
    recomputed on the same inputs, outside the call: expert ids, the keep
    mask) and the smallest gap between a token's k-th and (k+1)-th router
    probability."""
    inner = layers_mod.moe

    def moe(p, x, **kw):
        out, stats = inner(p, x, **kw)
        rec = {"expert_tokens": stats.expert_tokens}
        if routing:
            k = kw["top_k"]
            r = layers_mod.moe_route(
                p["router"], x.reshape(-1, x.shape[-1]), num_experts=kw["num_experts"],
                top_k=k, capacity_factor=kw["capacity_factor"],
                deterministic_capacity=kw.get("deterministic_capacity", 0))
            top = torch.sort(r.probs, dim=-1, descending=True).values
            rec.update(expert_ids=r.expert_ids.cpu(), keep=r.keep.cpu(),
                       gap=float((top[:, k - 1] - top[:, k]).min()))
        records.append(rec)
        return out, stats

    layers_mod.moe = moe
    try:
        yield records
    finally:
        layers_mod.moe = inner


def moe_serve_config(layers: int = MOE_SERVE_LAYERS, **over):
    return get_config(MOE_ARCH).replace(num_layers=layers, **over)


def phase_moe_serve() -> tuple:
    """[40] Mixtral 8x22B at its published widths (8 of 56 layers, bf16,
    random weights from seed ``SEED``) through ``launch.serve``: 2 prompts
    of 8,192 tokens (the window of 4,096 binds in K3), then 32 greedy steps
    on the wrapped ring of 4,096 slots (drop-free MoE, capacity B * k: every
    expert runs). An untimed run of the same request first records each
    prefill layer's ``expert_tokens`` and one K3 and one K4 input set;
    then the timed run, with the counts set to 0 just before it. Returns
    the summary, with the K3/K4 inputs under ``captured``."""
    cfg = moe_serve_config()
    nl, b, gen = cfg.num_layers, MOE_SERVE_BATCH, MOE_SERVE_GEN
    t0 = time.perf_counter()
    params = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name}: {nl} layers, d_model {cfg.d_model}, {cfg.num_experts} experts "
          f"(top {cfg.experts_per_token}) of d_ff {cfg.d_ff}, window {cfg.sliding_window}, "
          f"{n_params / 1e9:.3f} B params ({cfg.dtype}), random init from seed {SEED} in "
          f"{init_s:.1f} s; reduced: {MOE_SERVE_REDUCED}")
    records = []
    with record_moe(records):
        captured = capture_attention_inputs(cfg, params, b, MOE_SERVE_PROMPT, gen)
    expert_tokens = [r["expert_tokens"].tolist() for r in records[:nl]]
    check(all(sum(t) == b * MOE_SERVE_PROMPT * cfg.experts_per_token for t in expert_tokens),
          f"prefill expert_tokens {expert_tokens} do not sum to B x S x k")
    del records
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_decode.launches = 0
    res = serve_mod.serve(cfg, batch=b, prompt=MOE_SERVE_PROMPT, gen=gen, device=DEV,
                          seed=SEED, params=params)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    check(res.launches_prefill == {"flash_attention": nl, "flash_decode": 0, "flash_decode_lse": 0},
          f"prefill launches {res.launches_prefill}, want {nl} of K3 and none of K4")
    check(res.launches_decode == {"flash_attention": 0, "flash_decode": nl * gen,
                                  "flash_decode_lse": 0},
          f"decode launches {res.launches_decode}, want {nl} of K4 per step")
    check(launches == {"flash_attention": nl, "flash_decode": nl * gen},
          f"serving run launches {launches}")
    check(res.cache_pos == MOE_SERVE_PROMPT + gen,
          f"the cache is at {res.cache_pos}, want {MOE_SERVE_PROMPT + gen}")
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits), "non-finite logits")
    check(all(lg.shape == (b, cfg.vocab_size) for lg in res.logits), "logits shape")
    # a step reads every weight but the embedding (every expert runs at
    # capacity B * k) and each layer's valid cache: the ring's 4,096 slots
    weight_bytes = sum(p.numel() * p.element_size() for name, p in params.named_parameters()
                       if name != "embedding")
    cache_bytes = nl * 2 * b * cfg.num_kv_heads * cfg.sliding_window * cfg.head_dim * 2
    bound_ms = roofline(weight_bytes + cache_bytes, 0)[0]
    out = {"params": n_params, "init_s": init_s, "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token, "tok_per_s": res.tok_per_s,
           "peak_gb": peak / 1e9, "launches": launches, "expert_tokens": expert_tokens,
           "decode_bound_ms": bound_ms, "captured": captured}
    print(f"  prefill {b} x {MOE_SERVE_PROMPT}: {res.prefill_ms:.1f} ms; decode {gen} steps: "
          f"{res.decode_ms_per_token:.2f} ms/token, {res.tok_per_s:.1f} tok/s; peak memory "
          f"{peak / 1e9:.2f} GB; cache at position {res.cache_pos} (ring of "
          f"{cfg.sliding_window} slots)")
    print(f"  decode step against its weight-read bound: {res.decode_ms_per_token:.2f} ms "
          f"against {bound_ms:.2f} ms ({(weight_bytes + cache_bytes) / 1e9:.2f} GB at "
          f"{HW['hbm_bandwidth'] / 1e12:.2f} TB/s; {res.decode_ms_per_token / bound_ms:.2f}x)")
    print(f"  launches: prefill {res.launches_prefill}, decode {res.launches_decode}")
    for i, t in enumerate(expert_tokens):
        print(f"    layer {i} prefill expert_tokens {t}")
    print(f"  card: {card_line()}")
    print(f"  greedy tokens of sequence 0: {res.tokens[0][:16].tolist()}")
    out["decode_profile"] = phase_decode_profile(
        params, res.decode_ms_per_token, cfg, b, MOE_SERVE_PROMPT, gen, n=3,
        read_bytes=weight_bytes + cache_bytes, split_target_us=None, label="[40]")
    del params
    return out


def routing_same(card: list, host: list) -> bool:
    return len(card) == len(host) and all(
        torch.equal(c["expert_ids"], h["expert_ids"]) and torch.equal(c["keep"], h["keep"])
        and torch.equal(c["expert_tokens"].cpu(), h["expert_tokens"]) for c, h in zip(card, host))


def phase_moe_card_vs_host() -> dict:
    """[41] Mixtral at full width, f32, card against host from the same
    weights. (a) 1 layer through ``launch.serve``: 2 x 256 prompt tokens,
    then 4 greedy steps; logits within ``MOE_HOST_TOL``, tokens and every
    MoE call's routing (expert ids, keep mask, counts) identical. (b)
    ``moe`` alone under ``grad`` on a (2, 256, 6,144) input with that
    layer's expert stack: out and aux within ``MOE_HOST_TOL``,
    ``expert_tokens`` exact, the gradients of x and the four weights within
    ``MOE_HOST_TOL`` of the leaf's largest element (at least 1) and within
    ``LM_UPDATE_TOL`` in relative norm. The router's gradient sums every
    token's product with x through the softmax: its elements reach the
    thousands, where an f32 ulp is 1e-4, so an absolute 1e-4 would hold
    it to below its own rounding."""
    from torch.func import grad_and_value

    cfg = moe_serve_config(1, dtype="float32")
    card = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    host = transformer.make_params(cfg, device="cpu",
                                   state={k: v.cpu() for k, v in card.state_dict().items()})
    kw = dict(batch=2, prompt=MOE_HOST_PROMPT, gen=MOE_HOST_GEN, seed=SEED)
    rec_c, rec_h = [], []
    with record_moe(rec_c, routing=True):
        rc = serve_mod.serve(cfg, device=DEV, params=card, **kw)
    t0 = time.perf_counter()
    with record_moe(rec_h, routing=True):
        rh = serve_mod.serve(cfg, device="cpu", params=host, **kw)
    host_s = time.perf_counter() - t0
    check(rc.launches_prefill["flash_attention"] == 1, "card run missed K3")
    check(rh.launches_prefill["flash_attention"] == 0, "host run launched a kernel")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(rc.logits, rh.logits))
    check(all(torch.allclose(a.cpu(), b, rtol=MOE_HOST_TOL, atol=MOE_HOST_TOL)
              for a, b in zip(rc.logits, rh.logits)),
          f"card and host logits differ by {err}")
    check(torch.equal(rc.tokens.cpu(), rh.tokens), "card and host greedy tokens differ")
    gaps = [min(r["gap"] for r in rec) for rec in (rec_c, rec_h)]
    same = routing_same(rec_c, rec_h)
    print(f"  (a) 1 layer x d_model {cfg.d_model} f32, 2 x {MOE_HOST_PROMPT} prompt tokens, "
          f"{MOE_HOST_GEN} steps: max |logit diff| {err:.3g} (tolerance {MOE_HOST_TOL}); "
          f"tokens identical {rc.tokens[0].tolist()}; routing of {len(rec_c)} MoE calls "
          f"identical: {same}; smallest gap between the k-th and (k+1)-th router "
          f"probability: card {gaps[0]:.3g}, host {gaps[1]:.3g}; host run {host_s:.1f} s")
    check(same, "card and host route differently (see the gaps above)")

    rng = np.random.default_rng(SEED + 41)
    shape = (2, MOE_HOST_PROMPT, cfg.d_model)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    moe_kw = dict(num_experts=cfg.num_experts, top_k=cfg.experts_per_token,
                  capacity_factor=cfg.moe_capacity_factor)

    def loss(p, x, w):
        out, stats = layers_mod.moe(p, x, **moe_kw)
        return (out * w).sum() + stats.aux_loss, (out, stats)

    g = grad_and_value(loss, argnums=(0, 1), has_aux=True)
    sides = {}
    for side, model, dev in (("card", card, DEV), ("host", host, "cpu")):
        p = {n: t.detach() for n, t in model.layers[0].ffn.named_parameters()}
        t0 = time.perf_counter()
        (gp, gx), (_, (out, stats)) = g(p, x.to(dev), w.to(dev))
        sides[side] = ({**{n: t.cpu() for n, t in gp.items()}, "x": gx.cpu()}, out.cpu(),
                       stats, time.perf_counter() - t0)
    (gc, oc, sc, _), (gh, oh, sh, host_s) = sides["card"], sides["host"]
    out_err = float((oc - oh).abs().max())
    check(torch.allclose(oc, oh, rtol=MOE_HOST_TOL, atol=MOE_HOST_TOL),
          f"(b) moe's output differs between card and host by {out_err}")
    check(abs(float(sc.aux_loss) - float(sh.aux_loss)) <= MOE_HOST_TOL,
          f"(b) aux {float(sc.aux_loss)} against {float(sh.aux_loss)}")
    check(torch.equal(sc.expert_tokens.cpu(), sh.expert_tokens),
          f"(b) expert_tokens {sc.expert_tokens.tolist()} against {sh.expert_tokens.tolist()}")
    grad_err = {}
    for name, want in gh.items():
        got = gc[name]
        rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
        scale = max(1.0, float(want.abs().max()))
        grad_err[name] = (float((got - want).abs().max()), rel, scale)
        check(grad_err[name][0] <= MOE_HOST_TOL * scale and rel <= LM_UPDATE_TOL,
              f"(b) d{name} differs between card and host: (max abs, rel norm, scale) "
              f"{grad_err[name]}")
    print(f"  (b) moe under grad on {shape}, {cfg.num_experts} experts of {cfg.d_model} x "
          f"{cfg.d_ff}: out {out_err:.3g}, aux {abs(float(sc.aux_loss) - float(sh.aux_loss)):.3g}, "
          f"expert_tokens {sh.expert_tokens.tolist()} on both; gradients (max abs, rel norm): "
          + ", ".join(f"d{n} {a:.3g}/{r:.3g} (largest |element| {m:.3g})"
                      for n, (a, r, m) in grad_err.items())
          + f"; host {host_s:.1f} s")
    del card, host, sides
    return {"max_logit_diff": err, "router_gap": gaps, "grad_err": grad_err}


def phase_moe_training() -> dict:
    """[42] Mixtral through ``launch.train.train`` at its published widths
    (1 of 56 layers, f32, weights from seed ``SEED``) on [35]'s corpus and
    cohort, ``MOE_TRAIN_ROUNDS`` rounds per plan, the counts set to 0 just
    before each run and read just after; then ``make_round_step`` at the
    ``tiny`` scale (8 experts, f32) in four modes with ``heat_expert``, on
    the card and on the host."""
    cfg = moe_serve_config(1, dtype="float32")
    runs = {}
    for label, alg, sparse in MOE_PLANS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm_zero_counts()
        res = train_mod.train(cfg, rounds=MOE_TRAIN_ROUNDS, lr=LM_LR, algorithm=alg,
                              sparse=sparse, device=DEV, log_every=0, remat=False,
                              **LM_CORPUS)
        launches = lm_counts()
        peak = torch.cuda.max_memory_allocated()
        if not runs:
            n_params = sum(p.numel() for p in res.params.values())
            print(f"  {cfg.name}: {cfg.num_layers} layer, d_model {cfg.d_model}, "
                  f"{cfg.num_experts} experts of d_ff {cfg.d_ff}, {n_params / 1e9:.3f} B params "
                  f"({cfg.dtype}); reduced: {MOE_TRAIN_REDUCED}")
        check(all(math.isfinite(x) for x in res.losses), f"{label}: a loss is not finite")
        n = cfg.num_layers * MOE_TRAIN_ROUNDS
        check(launches == {"flash_attention": n, "flash_attention_bwd": n, "union_segsum": 0},
              f"{label}: launches {launches}, want {cfg.num_layers} of K3 and of its "
              "backward per round and no K1 (FedSgdLocal)")
        steady = statistics.median(res.ms_per_round[1:])
        runs[label] = {"losses": res.losses, "ms_per_round": res.ms_per_round,
                       "steady_ms_per_round": steady, "peak_gb": peak / 1e9,
                       "launches": launches, "bytes_up_sparse": res.bytes_up_sparse}
        print(f"  {label} ({res.plan}): loss {[round(x, 4) for x in res.losses]}")
        print(f"    ms/round: first {res.ms_per_round[0]:.1f}, steady {steady:.1f} (median "
              f"of rounds 2-{MOE_TRAIN_ROUNDS}); peak device memory {peak / 1e9:.2f} GB; "
              f"launches {launches}")
        if res.bytes_up_sparse:
            print(f"    uplink per round (cohort as one union): "
                  f"{[round(x / 1e6, 2) for x in res.bytes_up_sparse]} MB sparse against "
                  f"{res.bytes_up_dense[-1] / 1e6:.1f} MB dense")
        del res
    torch.cuda.empty_cache()

    steps, cohort, clients = 3, 4, 64
    tiny = get_config(MOE_ARCH).replace(**serve_mod.SCALES["tiny"])
    ds = make_lm_federated(num_clients=clients, vocab=tiny.vocab_size, seq_len=128,
                           samples_per_client=4, zipf_a=LM_CORPUS["zipf_a"])
    heat_expert = np.random.default_rng(SEED).integers(
        *MOE_HEAT_RANGE, tiny.num_experts).astype(np.float32)
    print(f"  tiny ({tiny.num_experts} experts, d_model {tiny.d_model}, f32), heat_expert "
          f"{heat_expert.tolist()}")
    for mode in LM_STEP_MODES:
        batches = [{**b, "heat_expert": heat_expert}
                   for b in lm_step_batches(ds, cohort, steps, "replicated" in mode)]
        init, axes = lm_params(tiny, DEV)
        host_init = {k: v.to("cpu", copy=True) for k, v in init.items()}
        losses, ms, params, launches = run_lm_steps(tiny, mode, DEV, batches, clients, cohort,
                                                    init, axes)
        want_k1 = steps if mode == "sparse_replicated" else 0
        check(all(math.isfinite(x) for x in losses), f"tiny {mode}: loss not finite")
        check(launches["union_segsum"] == want_k1,
              f"tiny {mode}: K1 launched {launches['union_segsum']} times in {steps} steps, "
              f"want {want_k1}")
        check(launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0,
              f"tiny {mode}: K3 or its backward did not launch: {launches}")
        h_losses, _, h_params, h_launches = run_lm_steps(tiny, mode, "cpu", batches, clients,
                                                         cohort, host_init, axes)
        check(sum(h_launches.values()) == 0, "the host run launched a kernel")
        err = max(float((params[k].cpu() - h_params[k]).abs().max()) for k in h_params)
        check(np.allclose(losses, h_losses, rtol=LM_STEP_TOL, atol=LM_STEP_TOL),
              f"tiny {mode}: card losses {losses} against host {h_losses}")
        check(all(torch.allclose(params[k].cpu(), h_params[k], rtol=LM_STEP_TOL,
                                 atol=LM_STEP_TOL) for k in h_params),
              f"tiny {mode}: card and host parameters differ by {err}")
        runs[f"tiny {mode}"] = launches
        print(f"  tiny {mode:17s}: loss {[round(x, 4) for x in losses]}, launches {launches}; "
              f"card against host: max |param diff| {err:.3g}")
        del params, h_params
    return runs


def uncounted_params(cfg) -> int:
    """The parameters the reference's ``param_counts`` leaves out of its
    total, which its tree holds: the final norm, QKV biases and QK norms;
    for Whisper, the decoder's cross-attention and its norm, the biases of
    every attention's ``wq``, ``wv`` and ``wo``, and the encoder's final
    norm (``tests/test_torch_configs.py::_uncounted``)."""
    q, kv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    per_layer = (q + 2 * kv) * cfg.qkv_bias + 2 * cfg.head_dim * cfg.qk_norm
    if cfg.family == "audio":
        d = cfg.d_model
        biases = q + kv + d
        per_layer = 2 * d * q + 2 * d * kv + d + 2 * biases
        return 2 * d + cfg.num_layers * per_layer + cfg.encoder_layers * biases
    return cfg.d_model + cfg.num_layers * per_layer


def phase_dense_configs() -> dict:
    """[43] Qwen3-32B, DeepSeek-67B and Mistral Large 123B at their published
    widths (2 layers each, bf16, random weights from seed ``SEED``) through
    ``launch.serve``: a prefill of 4 x 1,024 tokens and 8 greedy steps
    after a warm-up request, counts set to 0 just before; then every
    registered configuration's ``abstract_params`` at full depth on
    ``meta``."""
    out = {}
    for arch in DENSE_ARCHS:
        cfg = get_config(arch).replace(num_layers=DENSE_LAYERS)
        params = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
        n_params = sum(p.numel() for p in params.parameters())
        kw = dict(batch=DENSE_BATCH, prompt=DENSE_PROMPT, device=DEV, seed=SEED, params=params)
        serve_mod.serve(cfg, gen=2, **kw)
        torch.cuda.reset_peak_memory_stats()
        flash_attention.launches = 0
        flash_decode.launches = 0
        res = serve_mod.serve(cfg, gen=DENSE_GEN, **kw)
        peak = torch.cuda.max_memory_allocated()
        nl = cfg.num_layers
        check(res.launches_prefill == {"flash_attention": nl, "flash_decode": 0,
                                       "flash_decode_lse": 0}
              and res.launches_decode == {"flash_attention": 0, "flash_decode": nl * DENSE_GEN,
                                          "flash_decode_lse": 0},
              f"{arch}: launches {res.launches_prefill}, {res.launches_decode}")
        check(res.cache_pos == DENSE_PROMPT + DENSE_GEN, f"{arch}: cache at {res.cache_pos}")
        check(all(bool(torch.isfinite(lg).all()) for lg in res.logits),
              f"{arch}: non-finite logits")
        out[arch] = {"prefill_ms": res.prefill_ms, "decode_ms_per_token": res.decode_ms_per_token,
                     "tok_per_s": res.tok_per_s, "peak_gb": peak / 1e9,
                     "launches_prefill": res.launches_prefill,
                     "launches_decode": res.launches_decode}
        print(f"  {cfg.name}: {nl} layers, d_model {cfg.d_model}, H {cfg.num_heads} / KV "
              f"{cfg.num_kv_heads}, d_ff {cfg.d_ff}, {n_params / 1e9:.3f} B params "
              f"({cfg.dtype}); prefill {DENSE_BATCH} x {DENSE_PROMPT}: {res.prefill_ms:.1f} ms; "
              f"{res.decode_ms_per_token:.2f} ms/token, {res.tok_per_s:.1f} tok/s; peak "
              f"{peak / 1e9:.2f} GB; launches {res.launches_prefill}, {res.launches_decode}")
        del params, res
        torch.cuda.empty_cache()
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        model = build_model(cfg).abstract_params()
        n = sum(p.numel() for p in model.parameters())
        check(all(p.device.type == "meta" for p in model.parameters()),
              f"{arch}: abstract_params holds storage")
        if cfg.family in ("hybrid", "ssm"):
            # the reference's analytic count describes neither tree (it counts
            # Zamba2's shared block at every layer and gives xLSTM's blocks
            # Mamba2's widths); tests/test_torch_configs.py holds both trees
            # leaf by leaf to the reference's abstract tree
            print(f"  abstract_params {arch}: {n} parameters on meta (param_counts() "
                  "does not count this family's tree)")
            continue
        total, extra = cfg.param_counts()["total"], uncounted_params(cfg)
        check(n == total + extra, f"{arch}: abstract_params holds {n} parameters, "
              f"param_counts {total} + {extra} uncounted")
        left_out = ("cross-attention, its norms, the attention biases, the final norms"
                    if cfg.family == "audio" else "final norm, QKV biases, QK norms")
        print(f"  abstract_params {arch}: {cfg.num_layers} layers, {n} parameters on meta = "
              f"param_counts()['total'] {total} + {extra} it leaves out ({left_out})")
    return out


def phase_moe_slice(kernels: list, rng) -> list:
    """[39]-[43], each timed; adds [39]'s errors to K3's, K4's and K3
    backward's entries and returns this slice's rows of the kernels line."""
    print("[39] K3, K4 and K3's backward vs plain versions at the new configurations' shapes")
    t0 = time.perf_counter()
    err_k3, err_k4, err_bwd = phase_new_shapes(rng)
    by_name = {e["name"]: e for e in kernels}
    by_name["flash_attention"]["max_abs_err"] = max(by_name["flash_attention"]["max_abs_err"],
                                                    err_k3)
    by_name["flash_decode"]["max_abs_err"] = max(by_name["flash_decode"]["max_abs_err"], err_k4)
    by_name["flash_attention_bwd"]["max_abs_err"] = max(
        by_name["flash_attention_bwd"]["max_abs_err"], err_bwd)
    print(f"  [39] took {time.perf_counter() - t0:.1f} s")

    print(f"[40] serving path: {MOE_ARCH} at its published widths, {MOE_SERVE_LAYERS} layers")
    t0 = time.perf_counter()
    served = phase_moe_serve()
    rows = attention_timing(
        served.pop("captured"), served["launches"], err_k3, err_k4,
        names=("flash_attention (mixtral_8x22b prefill, window 4096)",
               "flash_decode (mixtral_8x22b ring step)"),
        want_window=get_config(MOE_ARCH).sliding_window, k3_target_ms=None)
    print(f"  [40] took {time.perf_counter() - t0:.1f} s")

    print("[41] card vs host: Mixtral at full width, f32, 1 layer served; moe alone under grad")
    t0 = time.perf_counter()
    phase_moe_card_vs_host()
    print(f"  [41] took {time.perf_counter() - t0:.1f} s")

    print(f"[42] federated training: {MOE_ARCH} at its published widths, 1 layer, f32, "
          f"{LM_CORPUS}, {MOE_TRAIN_ROUNDS} rounds per plan; tiny make_round_step with "
          "heat_expert, card vs host")
    t0 = time.perf_counter()
    trained = phase_moe_training()
    moe_cfg = get_config(MOE_ARCH)
    _, bwd = train_attention_timing((*LM_TRAIN_SHAPE, moe_cfg.num_heads, moe_cfg.num_kv_heads,
                                     moe_cfg.head_dim), SEED + 42, "mixtral training shape")
    rows.append({"name": "flash_attention_bwd (mixtral_8x22b training)", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 "replaces": "src/repro/models/layers.py:154",
                 "launches": sum(trained[label]["launches"]["flash_attention_bwd"]
                                 for label, _, _ in MOE_PLANS), **bwd})
    print(f"  [42] took {time.perf_counter() - t0:.1f} s")

    print(f"[43] the dense configurations at their published widths, {DENSE_LAYERS} layers "
          "each; abstract_params at full depth")
    t0 = time.perf_counter()
    phase_dense_configs()
    print(f"  [43] took {time.perf_counter() - t0:.1f} s")
    return rows


VLM_ARCH, L4_ARCH = "qwen2_vl_7b", "llama4_maverick_400b_a17b"
#: [45]: 4 prompts of 2,048 positions, the first 1,024 an image of 32 x 32
#: patches (Qwen2-VL's M-RoPE grid), then 1,024 text tokens; 32 steps
VLM_BATCH, VLM_PROMPT, VLM_GEN, VLM_GRID = 4, 2048, 32, (32, 32)
#: [46]: 2 prompts of 2,048 tokens, the first 256 patches (early fusion)
L4_BATCH, L4_PROMPT, L4_GEN, L4_LAYERS = 2, 2048, 32, 2
L4_REDUCED = ("layers 48 -> {n}: a layer holds 16.17 B bf16 parameters (32.34 GB), almost "
              "all of them its 128 experts; with the embedding and lm_head (4.14 GB), 2 "
              "layers take 68.8 GB of the card's 80 and 48 would take ~1.56 TB")
#: [47]: one full-width f32 Qwen2-VL layer, 1 prompt of 1,280 positions (the
#: 32 x 32 image, then 256 text tokens), 4 steps; Llama 4 at its smoke widths
VLM_HOST_PROMPT, VLM_HOST_GEN, VLM_HOST_TOL = 1280, 4, 1e-4
L4_HOST_TOL = 1e-5
#: [48] (a): Qwen2-VL at its published widths in f32, 4 layers, cohort 4 at
#: seq 2,048 (each sequence opens with the 32 x 32 image), 3 rounds per remat
#: setting; then the deepest depth a round trains at, 4 tries per setting,
#: the first at the deepest depth one round was seen to train at on an H100
#: 80GB (5 layers without remat, 23 with: PRs 23 and 25), so that two tries
#: settle it there
VLM_TRAIN_LAYERS, VLM_TRAIN_ROUNDS, VLM_DEPTH_TRIES = 4, 3, 4
VLM_TRAIN = dict(clients=64, cohort=4, seq=2048, zipf_a=1.3)
VLM_DEPTH_GUESS = {False: 5, True: 23}
#: [48] (b): microbatches 2 against 1, the reference test's tolerances
VLM_MB_TOL = dict(rtol=2e-4, atol=2e-5)
#: [44]'s K3 cases (name, B, S, H, KV) at the two prefills, bf16
VLM_K3_CASES = (("qwen2-vl-7b prefill", VLM_BATCH, VLM_PROMPT, 28, 4),
                ("llama4-maverick prefill", L4_BATCH, L4_PROMPT, 40, 8))
#: [44]'s K4 cases (name, B, H, KV, slots), each cache full after its steps
VLM_K4_CASES = (("qwen2-vl-7b step", VLM_BATCH, 28, 4, VLM_PROMPT + VLM_GEN),
                ("llama4-maverick step", L4_BATCH, 40, 8, L4_PROMPT + L4_GEN))
#: [44]'s K3-backward cases (name, (B, S, H, KV, hd)), f32: GQA groups of 7
#: (Qwen2-VL's 28 / 4) and 5 (Llama 4's 40 / 8) at [38]'s B 16 x S 128, and
#: Qwen2-VL's training shape
VLM_BWD_CASES = (("group 7", (16, 128, 28, 4, 128)), ("group 5", (16, 128, 40, 8, 128)),
                 ("qwen2-vl training", (VLM_TRAIN["cohort"], VLM_TRAIN["seq"], 28, 4, 128)))


def vlm_inputs(cfg, batch: int, prompt: int, dtype=None, seed: int = SEED) -> dict:
    """Random patch embeddings (numpy, ``seed``) for a prompt's first
    ``num_patches`` positions and, with M-RoPE, the streams of a
    ``VLM_GRID`` image followed by text, on the card."""
    rng = np.random.default_rng(seed)
    patches = rng.standard_normal((batch, cfg.num_patches, cfg.d_model), dtype=np.float32)
    out = {"patch_embeds": torch.from_numpy(patches).to(DEV, dtype or transformer.model_dtype(cfg))}
    if cfg.mrope:
        out["mrope_pos"] = serve_mod.image_grid_positions(batch, prompt, *VLM_GRID).to(DEV)
    return out


def phase_vlm_shapes(rng) -> dict:
    """[44] K3 (bf16) at the two prefills' shapes and K4 (bf16 and f32) at
    the two decode steps' against their plain versions; K3's backward (f32)
    at GQA groups of 7 and 5 and at Qwen2-VL's training shape, held to its
    plain version and timed beside SDPA's (``train_attention_timing``).
    Returns the worst errors and the backward's timings."""
    worst = {"k3": 0.0, "k4": 0.0, "bwd": 0.0}
    hd = 128
    for name, b, s, h, kv in VLM_K3_CASES:
        dtype = torch.bfloat16
        q, k, v = (normal(rng, (b, s, h, hd), dtype), normal(rng, (b, s, kv, hd), dtype),
                   normal(rng, (b, s, kv, hd), dtype))
        err = compare(f"flash_attention[{name}]", flash_attention(q, k, v),
                      flash_attention_torch(q, k, v), dtype)
        worst["k3"] = max(worst["k3"], err)
        print(f"  K3 {name:24s} {str(dtype):14s} B={b} S={s} H={h} KV={kv} hd={hd} "
              f"max_abs_err={err:.3g}")
        del q, k, v
    for name, b, h, kv, slots in VLM_K4_CASES:
        kpos = cache_slot_positions(slots, slots, False, DEV)
        for dtype in (torch.bfloat16, torch.float32):
            q = normal(rng, (b, h, hd), dtype)
            kc, vc = normal(rng, (b, kv, slots, hd), dtype), normal(rng, (b, kv, slots, hd), dtype)
            err = compare(f"flash_decode[{name}]",
                          flash_decode(q, kc, vc, kpos, slots - 1).float(),
                          flash_decode_torch(q, kc, vc, kpos, slots - 1).float(), dtype)
            worst["k4"] = max(worst["k4"], err)
            print(f"  K4 {name:24s} {str(dtype):14s} B={b} H={h} KV={kv} S={slots} hd={hd} "
                  f"max_abs_err={err:.3g}")
    timed = {}
    for name, shape in VLM_BWD_CASES:
        cluster = bwd_cluster(shape[2], shape[3])
        check(cluster == shape[2] // shape[3],
              f"{name}: cluster {cluster}, want the whole group of {shape[2] // shape[3]}")
        print(f"  {name}: GQA group {shape[2] // shape[3]}, dK/dV cluster {cluster} (its grid "
              f"is key tiles x {cluster} blocks wide)")
        fwd, bwd = train_attention_timing(shape, SEED + 44, name)
        worst["k3"] = max(worst["k3"], fwd["max_abs_err"])
        worst["bwd"] = max(worst["bwd"], bwd["max_abs_err"])
        timed[name] = bwd
    return {**worst, "bwd_timed": timed}


def vlm_serve_checks(label: str, res, launches: dict, nl: int, prompt: int, gen: int, b: int,
                     vocab: int) -> None:
    check(res.launches_prefill == {"flash_attention": nl, "flash_decode": 0, "flash_decode_lse": 0},
          f"{label}: prefill launches {res.launches_prefill}, want {nl} of K3 and none of K4")
    check(res.launches_decode == {"flash_attention": 0, "flash_decode": nl * gen,
                                  "flash_decode_lse": 0},
          f"{label}: decode launches {res.launches_decode}, want {nl} of K4 per step")
    check(launches == {"flash_attention": nl, "flash_decode": nl * gen},
          f"{label}: serving run launches {launches}")
    check(res.cache_pos == prompt + gen, f"{label}: the cache is at {res.cache_pos}")
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits), f"{label}: non-finite logits")
    check(all(lg.shape == (b, vocab) for lg in res.logits), f"{label}: logits shape")


def phase_vlm_serve() -> dict:
    """[45] Qwen2-VL 7B at full size (28 layers, bf16, weights from seed
    ``SEED``) through ``launch.serve`` with [45]'s image prompts and
    M-RoPE streams; an untimed run first records one K3 and one K4 input
    set, then the timed run with the counts set to 0 just before; then
    where a step's and a prefill's time goes."""
    cfg = get_config(VLM_ARCH)
    nl, b, prompt, gen = cfg.num_layers, VLM_BATCH, VLM_PROMPT, VLM_GEN
    t0 = time.perf_counter()
    params = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    inputs = vlm_inputs(cfg, b, prompt)
    print(f"  {cfg.name}: {nl} layers, d_model {cfg.d_model}, H {cfg.num_heads} / KV "
          f"{cfg.num_kv_heads}, d_ff {cfg.d_ff}, M-RoPE sections {cfg.mrope_sections}, "
          f"{n_params / 1e9:.3f} B params ({cfg.dtype}), random init from seed {SEED} in "
          f"{init_s:.1f} s; reduced: none")
    print(f"  prompts: {b} x {prompt}: {cfg.num_patches} patch embeddings (numpy seed {SEED}) "
          f"on a {VLM_GRID[0]} x {VLM_GRID[1]} grid (t 0, h i // {VLM_GRID[1]}, w i % "
          f"{VLM_GRID[1]}), then {prompt - cfg.num_patches} text tokens at {max(VLM_GRID)} + j "
          f"on all three streams; steps from {max(VLM_GRID) + prompt - cfg.num_patches} on")
    captured = capture_attention_inputs(cfg, params, b, prompt, gen, **inputs)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_decode.launches = 0
    res = serve_mod.serve(cfg, batch=b, prompt=prompt, gen=gen, device=DEV, seed=SEED,
                          params=params, **inputs)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    vlm_serve_checks("[45]", res, launches, nl, prompt, gen, b, cfg.vocab_size)
    weight_bytes = sum(p.numel() * p.element_size() for name, p in params.named_parameters()
                       if name != "embedding")
    cache_bytes = nl * 2 * b * cfg.num_kv_heads * (prompt + gen) * cfg.head_dim * 2
    all_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    bound_ms = roofline(all_bytes, 0)[0]
    print(f"  prefill {b} x {prompt}: {res.prefill_ms:.1f} ms; decode {gen} steps: "
          f"{res.decode_ms_per_token:.2f} ms/step, {res.tok_per_s:.1f} tok/s; peak memory "
          f"{peak / 1e9:.2f} GB; launches: prefill {res.launches_prefill}, decode "
          f"{res.launches_decode}")
    print(f"  decode step against its weight-read bound: {res.decode_ms_per_token:.2f} ms "
          f"against {bound_ms:.2f} ms ({all_bytes / 1e9:.2f} GB of weights at "
          f"{HW['hbm_bandwidth'] / 1e12:.2f} TB/s; {res.decode_ms_per_token / bound_ms:.2f}x); "
          f"what a step reads (every weight but the embedding table, the valid cache) "
          f"{(weight_bytes + cache_bytes) / 1e9:.2f} GB, "
          f"{roofline(weight_bytes + cache_bytes, 0)[0]:.2f} ms")
    print(f"  card: {card_line()}")
    print(f"  greedy tokens of sequence 0: {res.tokens[0][:16].tolist()}")
    out = {"params": n_params, "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token, "tok_per_s": res.tok_per_s,
           "peak_gb": peak / 1e9, "launches": launches, "decode_bound_ms": bound_ms,
           "captured": captured}
    out["decode_profile"] = phase_decode_profile(
        params, res.decode_ms_per_token, cfg, b, prompt, gen, n=3,
        read_bytes=weight_bytes + cache_bytes, split_target_us=None, label="[45]",
        inputs=inputs)
    out["prefill_profile"] = phase_prefill_profile(params, res.prefill_ms, cfg, b, prompt,
                                                   inputs, label="[45]")
    del params
    torch.cuda.empty_cache()
    return out


def phase_l4_serve() -> dict:
    """[46] Llama 4 Maverick at its published widths, ``L4_LAYERS`` of its
    48 layers (the prefill fits beside their 68.8 GB: peak 69.53 GB on an
    H100 80GB): draw the weights, record the prefill's ``expert_tokens``
    and one K3 and K4 input set in an untimed run, then the timed run with
    the counts set to 0 just before."""
    cfg = get_config(L4_ARCH).replace(num_layers=L4_LAYERS)
    nl, b, prompt, gen = cfg.num_layers, L4_BATCH, L4_PROMPT, L4_GEN
    t0 = time.perf_counter()
    params = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    inputs = vlm_inputs(cfg, b, prompt)
    print(f"  {cfg.name}: {nl} layers, d_model {cfg.d_model}, H {cfg.num_heads} / KV "
          f"{cfg.num_kv_heads}, {cfg.num_experts} experts (top {cfg.experts_per_token}) of "
          f"d_ff {cfg.d_ff}, {n_params / 1e9:.3f} B params ({cfg.dtype}), random init from "
          f"seed {SEED} in {init_s:.1f} s (tensors above "
          f"{transformer.DRAW_WHOLE_MAX} elements drawn in slices); reduced: "
          f"{L4_REDUCED.format(n=nl)}")
    records = []
    with record_moe(records):
        captured = capture_attention_inputs(cfg, params, b, prompt, gen, **inputs)
    expert_tokens = [r["expert_tokens"].tolist() for r in records[:nl]]
    check(all(sum(t) == b * prompt * cfg.experts_per_token for t in expert_tokens),
          "[46]: prefill expert_tokens do not sum to B x S x k")
    del records
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_decode.launches = 0
    res = serve_mod.serve(cfg, batch=b, prompt=prompt, gen=gen, device=DEV, seed=SEED,
                          params=params, **inputs)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    vlm_serve_checks("[46]", res, launches, nl, prompt, gen, b, cfg.vocab_size)
    # decode is drop-free at capacity B * k: every expert runs, so a step
    # reads every weight but the embedding table, and the valid cache
    weight_bytes = sum(p.numel() * p.element_size() for name, p in params.named_parameters()
                       if name != "embedding")
    cache_bytes = nl * 2 * b * cfg.num_kv_heads * (prompt + gen) * cfg.head_dim * 2
    bound_ms = roofline(weight_bytes + cache_bytes, 0)[0]
    print(f"  prefill {b} x {prompt}: {res.prefill_ms:.1f} ms; decode {gen} steps: "
          f"{res.decode_ms_per_token:.2f} ms/step, {res.tok_per_s:.1f} tok/s; peak memory "
          f"{peak / 1e9:.2f} GB; launches: prefill {res.launches_prefill}, decode "
          f"{res.launches_decode}")
    print(f"  decode step against its weight-read bound: {res.decode_ms_per_token:.2f} ms "
          f"against {bound_ms:.2f} ms ({(weight_bytes + cache_bytes) / 1e9:.2f} GB at "
          f"{HW['hbm_bandwidth'] / 1e12:.2f} TB/s; {res.decode_ms_per_token / bound_ms:.2f}x)")
    for i, t in enumerate(expert_tokens):
        busy = sum(1 for x in t if x)
        print(f"    layer {i} prefill expert_tokens ({busy} of {cfg.num_experts} experts "
              f"take tokens, most {max(t)}): {t}")
    print(f"  card: {card_line()}")
    print(f"  greedy tokens of sequence 0: {res.tokens[0][:16].tolist()}")
    out = {"layers": nl, "params": n_params, "init_s": init_s, "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token, "tok_per_s": res.tok_per_s,
           "peak_gb": peak / 1e9, "launches": launches, "expert_tokens": expert_tokens,
           "decode_bound_ms": bound_ms, "captured": captured}
    out["decode_profile"] = phase_decode_profile(
        params, res.decode_ms_per_token, cfg, b, prompt, gen, n=3,
        read_bytes=weight_bytes + cache_bytes, split_target_us=None, label="[46]",
        inputs=inputs)
    del params
    return out


def phase_vlm_card_vs_host() -> dict:
    """[47] card against host from the same weights. (a) Qwen2-VL at one
    full-width f32 layer through ``launch.serve``: 1 prompt of
    ``VLM_HOST_PROMPT`` positions ([45]'s image and streams, then text), 4
    steps; logits within ``VLM_HOST_TOL``, greedy tokens identical. (b)
    Llama 4 at its smoke widths in f32 (one full-width f32 layer, 64.7 GB,
    does not fit beside a host copy): 2 x 64 tokens, the first 8 patches,
    4 steps; logits within ``L4_HOST_TOL``, every MoE call's routing and
    ``expert_tokens`` identical, the smallest top-1 router gap printed."""
    out = {}
    cfg = get_config(VLM_ARCH).replace(num_layers=1, dtype="float32")
    card = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    host = transformer.make_params(cfg, device="cpu",
                                   state={k: v.cpu() for k, v in card.state_dict().items()})
    inputs = vlm_inputs(cfg, 1, VLM_HOST_PROMPT)
    kw = dict(batch=1, prompt=VLM_HOST_PROMPT, gen=VLM_HOST_GEN, seed=SEED)
    rc = serve_mod.serve(cfg, device=DEV, params=card, **kw, **inputs)
    t0 = time.perf_counter()
    rh = serve_mod.serve(cfg, device="cpu", params=host, **kw,
                         **{k: v.cpu() for k, v in inputs.items()})
    host_s = time.perf_counter() - t0
    check(rc.launches_prefill["flash_attention"] == 1, "[47] (a): card run missed K3")
    check(rh.launches_prefill["flash_attention"] == 0, "[47] (a): host run launched a kernel")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(rc.logits, rh.logits))
    check(all(torch.allclose(a.cpu(), b, rtol=VLM_HOST_TOL, atol=VLM_HOST_TOL)
              for a, b in zip(rc.logits, rh.logits)),
          f"[47] (a): card and host logits differ by {err}")
    check(torch.equal(rc.tokens.cpu(), rh.tokens), "[47] (a): card and host tokens differ")
    print(f"  (a) {cfg.name} 1 layer x d_model {cfg.d_model} f32, 1 x {VLM_HOST_PROMPT} "
          f"positions ({cfg.num_patches} patches on the grid), {VLM_HOST_GEN} steps: max "
          f"|logit diff| {err:.3g} (tolerance {VLM_HOST_TOL}); tokens identical "
          f"{rc.tokens[0].tolist()}; host run {host_s:.1f} s")
    out["qwen2_vl_max_logit_diff"] = err
    del card, host, rc, rh
    torch.cuda.empty_cache()

    cfg = get_smoke_config(L4_ARCH).replace(dtype="float32")
    card = transformer.make_params(cfg, torch.Generator(device=DEV).manual_seed(SEED), DEV)
    host = transformer.make_params(cfg, device="cpu",
                                   state={k: v.cpu() for k, v in card.state_dict().items()})
    inputs = vlm_inputs(cfg, 2, 64)
    kw = dict(batch=2, prompt=64, gen=4, seed=SEED)
    rec_c, rec_h = [], []
    with record_moe(rec_c, routing=True):
        rc = serve_mod.serve(cfg, device=DEV, params=card, **kw, **inputs)
    with record_moe(rec_h, routing=True):
        rh = serve_mod.serve(cfg, device="cpu", params=host, **kw,
                             **{k: v.cpu() for k, v in inputs.items()})
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(rc.logits, rh.logits))
    check(all(torch.allclose(a.cpu(), b, rtol=L4_HOST_TOL, atol=L4_HOST_TOL)
              for a, b in zip(rc.logits, rh.logits)),
          f"[47] (b): card and host logits differ by {err}")
    check(torch.equal(rc.tokens.cpu(), rh.tokens), "[47] (b): card and host tokens differ")
    gaps = [min(r["gap"] for r in rec) for rec in (rec_c, rec_h)]
    same = routing_same(rec_c, rec_h)
    print(f"  (b) {cfg.name} at its smoke widths (d_model {cfg.d_model}, {cfg.num_experts} "
          f"experts, top {cfg.experts_per_token}) f32, 2 x 64 tokens ({cfg.num_patches} "
          f"patches), 4 steps: max |logit diff| {err:.3g} (tolerance {L4_HOST_TOL}); routing "
          f"and expert_tokens of {len(rec_c)} MoE calls identical: {same}; smallest top-1 "
          f"router gap: card {gaps[0]:.3g}, host {gaps[1]:.3g}")
    check(same, "[47] (b): card and host route differently")
    out.update(l4_max_logit_diff=err, l4_router_gap=gaps)
    return out


def vlm_train_inputs(cfg) -> dict:
    """Each cohort batch's patches (f32, numpy seed ``SEED``) and image-grid
    streams at ``VLM_TRAIN``'s cohort and sequence length."""
    return vlm_inputs(cfg, VLM_TRAIN["cohort"], VLM_TRAIN["seq"], dtype=torch.float32)


def vlm_round_fits(layers: int, remat: bool) -> tuple:
    """One training round of Qwen2-VL at ``layers`` (f32, [48]'s batch):
    whether it ran, its peak memory and its host-clock ms."""
    cfg = get_config(VLM_ARCH).replace(num_layers=layers, dtype="float32")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        res = train_mod.train(cfg, rounds=1, lr=LM_LR, device=DEV, log_every=0, remat=remat,
                              inputs=vlm_train_inputs(cfg), **VLM_TRAIN)
        ok, ms = math.isfinite(res.losses[0]), res.ms_per_round[0]
        del res
    except torch.cuda.OutOfMemoryError:
        ok, ms = False, None
    peak = torch.cuda.max_memory_allocated()
    return ok, peak / 1e9, ms


def deepest_depth(remat: bool) -> dict:
    """The deepest Qwen2-VL depth at which one round trains, in at most
    ``VLM_DEPTH_TRIES`` tries from ``VLM_DEPTH_GUESS`` (the known fit is
    ``VLM_TRAIN_LAYERS``): one layer up while it fits, then halving the
    gap."""
    lo, hi, tries = VLM_TRAIN_LAYERS, None, []
    cand = VLM_DEPTH_GUESS[remat]
    for _ in range(VLM_DEPTH_TRIES):
        ok, peak, ms = vlm_round_fits(cand, remat)
        tries.append({"layers": cand, "trained": ok, "peak_gb": peak, "ms": ms})
        print(f"    remat {'on ' if remat else 'off'}: {cand} layers "
              f"{'trained' if ok else 'out of memory'}; peak {peak:.2f} GB"
              + (f", {ms:.0f} ms" if ms else ""))
        if ok:
            lo = max(lo, cand)
        else:
            hi = cand if hi is None else min(hi, cand)
        if hi is not None and hi - lo <= 1:
            break
        cand = (lo + hi) // 2 if hi is not None else cand + 1
    return {"deepest_trained": lo, "shallowest_refused": hi, "tries": tries}


def vlm_step_batch(cfg, b: int = 4, s: int = 16) -> dict:
    rng = np.random.default_rng(SEED + 48)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)),
            "labels": torch.ones((b, s), dtype=torch.int32),
            "mask": torch.ones((b, s)),
            "mrope_pos": serve_mod.image_grid_positions(b, s, 2, 4),
            "patch_embeds": torch.from_numpy(rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model), dtype=np.float32)),
            "heat_vocab": torch.ones(cfg.vocab_size)}


def phase_vlm_training() -> dict:
    """[48] (a) Qwen2-VL through ``launch.train.train`` at its published
    widths (f32, ``VLM_TRAIN_LAYERS`` layers, cohort 4 at seq 2,048 on
    ``make_lm_federated``, lr ``LM_LR``), every batch carrying 1,024 patch
    embeddings and the image's streams: ``VLM_TRAIN_ROUNDS`` rounds with
    remat off and on, the counts set to 0 just before each run; then the
    deepest depth a round trains at in each setting. (b) ``make_round_step``
    on the Qwen2-VL smoke config with ``mrope_pos`` in the batch: 2
    microbatches against 1, remat on against off. (c) ``make_round_step``
    on the Llama 4 smoke config with patches and ``heat_expert`` in four
    modes, card against host, K1 once per ``sparse_replicated`` step."""
    out = {}
    cfg = get_config(VLM_ARCH).replace(num_layers=VLM_TRAIN_LAYERS, dtype="float32")
    inputs = vlm_train_inputs(cfg)
    for remat in (False, True):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm_zero_counts()
        res = train_mod.train(cfg, rounds=VLM_TRAIN_ROUNDS, lr=LM_LR, device=DEV, log_every=0,
                              remat=remat, inputs=inputs, **VLM_TRAIN)
        launches = lm_counts()
        peak = torch.cuda.max_memory_allocated()
        n = cfg.num_layers * VLM_TRAIN_ROUNDS
        want = {"flash_attention": 2 * n if remat else n, "flash_attention_bwd": n,
                "union_segsum": 0}
        check(launches == want, f"[48] (a) remat {remat}: launches {launches}, want {want}")
        check(all(math.isfinite(x) for x in res.losses), f"[48] (a) remat {remat}: loss")
        steady = statistics.median(res.ms_per_round[1:])
        label = "remat on" if remat else "remat off"
        out[label] = {"losses": res.losses, "ms_per_round": res.ms_per_round,
                      "steady_ms_per_round": steady, "peak_gb": peak / 1e9,
                      "launches": launches}
        if not remat:
            n_params = sum(p.numel() for p in res.params.values())
            print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
                  f"{n_params / 1e9:.3f} B params (f32); {VLM_TRAIN}, lr {LM_LR}; reduced: "
                  f"layers 28 -> {cfg.num_layers} (f32 parameters, gradients, update and new "
                  "parameters of all 28 would be ~122 GB)")
        print(f"  {label}: loss {[round(x, 5) for x in res.losses]}; ms/round: first "
              f"{res.ms_per_round[0]:.1f}, steady {steady:.1f} (median of rounds 2-"
              f"{VLM_TRAIN_ROUNDS}); peak device memory {peak / 1e9:.2f} GB; launches {launches}")
        del res
    off, on = out["remat off"], out["remat on"]
    diff = max(abs(a - b) for a, b in zip(off["losses"], on["losses"]))
    check(diff <= LM_HOST_TOL * max(1.0, max(abs(x) for x in off["losses"])),
          f"[48] (a): remat on and off losses differ by {diff}")
    print(f"  remat costs {on['steady_ms_per_round'] - off['steady_ms_per_round']:.1f} ms a "
          f"round ({on['steady_ms_per_round'] / off['steady_ms_per_round']:.3f}x) and saves "
          f"{off['peak_gb'] - on['peak_gb']:.2f} GB of peak memory; losses differ by at most "
          f"{diff:.3g} (held to {LM_HOST_TOL} of the loss: the embedding's gradient is "
          "summed by atomics)")
    for remat in (False, True):
        out[f"depth remat {'on' if remat else 'off'}"] = deepest_depth(remat)
    print(f"  deepest depth that trains one round: remat off "
          f"{out['depth remat off']['deepest_trained']}, remat on "
          f"{out['depth remat on']['deepest_trained']} (first refusals "
          f"{out['depth remat off']['shallowest_refused']} and "
          f"{out['depth remat on']['shallowest_refused']})")
    torch.cuda.empty_cache()

    smoke = get_smoke_config(VLM_ARCH).replace(dtype="float32")
    params0, axes = lm_params(smoke, DEV)
    api = build_model(smoke)
    batch = {k: v.to(DEV) for k, v in vlm_step_batch(smoke).items()}
    got = {}
    lm_zero_counts()
    for nmb, remat in ((1, True), (2, True), (1, False)):
        fed = FedConfig(num_clients=10, lr=0.1, algorithm="fedsubavg", microbatches=nmb)
        step = make_round_step(lambda p, b, r=remat: api.loss(p, b, remat=r), params0, axes,
                               fed, mode="fedsgd")
        got[(nmb, remat)], _ = step({k: v.clone() for k, v in params0.items()}, batch)
    check(lm_counts()["flash_attention_bwd"] > 0, "[48] (b): K3's backward did not launch")
    mb_err = max(float((got[(2, True)][k] - got[(1, True)][k]).abs().max()) for k in params0)
    check(all(torch.allclose(got[(2, True)][k], got[(1, True)][k], **VLM_MB_TOL)
              for k in params0), f"[48] (b): 2 microbatches against 1 differ by {mb_err}")
    rm_err = max(float((got[(1, True)][k] - got[(1, False)][k]).abs().max()) for k in params0)
    check(all(torch.allclose(got[(1, True)][k], got[(1, False)][k], rtol=LM_STEP_TOL,
                             atol=LM_STEP_TOL) for k in params0),
          f"[48] (b): remat on against off differ by {rm_err}")
    print(f"  (b) qwen2-vl smoke make_round_step with mrope_pos (3, 4, 16) and patches: 2 "
          f"microbatches against 1 max |param diff| {mb_err:.3g} (rtol 2e-4, atol 2e-5); remat "
          f"on against off {rm_err:.3g} (tolerance {LM_STEP_TOL})")
    out.update(microbatch_diff=mb_err, remat_diff=rm_err)

    steps, cohort, clients = 3, 4, 64
    l4 = get_smoke_config(L4_ARCH).replace(dtype="float32")
    ds = make_lm_federated(num_clients=clients, vocab=l4.vocab_size, seq_len=64,
                           samples_per_client=4, zipf_a=LM_CORPUS["zipf_a"])
    heat_expert = np.random.default_rng(SEED).integers(
        *MOE_HEAT_RANGE, l4.num_experts).astype(np.float32)
    prng = np.random.default_rng(SEED + 49)
    for mode in LM_STEP_MODES:
        batches = [{**b, "heat_expert": heat_expert,
                    "patch_embeds": prng.standard_normal(
                        b["tokens"].shape[:-1] + (l4.num_patches, l4.d_model), dtype=np.float32)}
                   for b in lm_step_batches(ds, cohort, steps, "replicated" in mode)]
        init, axes = lm_params(l4, DEV)
        host_init = {k: v.to("cpu", copy=True) for k, v in init.items()}
        losses, _, params, launches = run_lm_steps(l4, mode, DEV, batches, clients, cohort,
                                                   init, axes)
        want_k1 = steps if mode == "sparse_replicated" else 0
        check(launches["union_segsum"] == want_k1,
              f"[48] (c) {mode}: K1 launched {launches['union_segsum']} times, want {want_k1}")
        check(launches["flash_attention"] > 0 and launches["flash_attention_bwd"] > 0,
              f"[48] (c) {mode}: K3 or its backward did not launch: {launches}")
        h_losses, _, h_params, h_launches = run_lm_steps(l4, mode, "cpu", batches, clients,
                                                         cohort, host_init, axes)
        check(sum(h_launches.values()) == 0, "[48] (c): the host run launched a kernel")
        err = max(float((params[k].cpu() - h_params[k]).abs().max()) for k in h_params)
        check(np.allclose(losses, h_losses, rtol=LM_STEP_TOL, atol=LM_STEP_TOL),
              f"[48] (c) {mode}: card losses {losses} against host {h_losses}")
        check(all(torch.allclose(params[k].cpu(), h_params[k], rtol=LM_STEP_TOL,
                                 atol=LM_STEP_TOL) for k in h_params),
              f"[48] (c) {mode}: card and host parameters differ by {err}")
        out[f"l4 smoke {mode}"] = launches
        print(f"  (c) llama4 smoke {mode:17s}: loss {[round(x, 4) for x in losses]}, launches "
              f"{launches}; card against host: max |param diff| {err:.3g}")
        del params, h_params
    return out


def phase_vlm_slice(kernels: list, rng) -> list:
    """[44]-[48], each timed; adds [44]'s errors to K3's, K4's and K3
    backward's entries and returns this slice's rows of the kernels line."""
    print("[44] K3, K4 and K3's backward vs plain versions at Qwen2-VL's and Llama 4's shapes")
    t0 = time.perf_counter()
    shapes = phase_vlm_shapes(rng)
    by_name = {e["name"]: e for e in kernels}
    for name, key in (("flash_attention", "k3"), ("flash_decode", "k4"),
                      ("flash_attention_bwd", "bwd")):
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], shapes[key])
    print(f"  [44] took {time.perf_counter() - t0:.1f} s")

    print(f"[45] serving path: {VLM_ARCH} at full size, {VLM_BATCH} x {VLM_PROMPT} image "
          f"prompts, {VLM_GEN} steps")
    t0 = time.perf_counter()
    served = phase_vlm_serve()
    rows = attention_timing(served.pop("captured"), served["launches"], shapes["k3"],
                            shapes["k4"], names=("flash_attention (qwen2_vl_7b prefill)",
                                                 "flash_decode (qwen2_vl_7b step)"),
                            k3_target_ms=None)
    print(f"  [45] took {time.perf_counter() - t0:.1f} s")

    print(f"[46] serving path: {L4_ARCH} at its published widths, {L4_BATCH} x {L4_PROMPT} "
          f"prompts ({get_config(L4_ARCH).num_patches} patches), {L4_GEN} steps")
    t0 = time.perf_counter()
    l4 = phase_l4_serve()
    rows += attention_timing(l4.pop("captured"), l4["launches"], shapes["k3"], shapes["k4"],
                             names=("flash_attention (llama4_maverick prefill)",
                                    "flash_decode (llama4_maverick step)"), k3_target_ms=None)
    torch.cuda.empty_cache()
    print(f"  [46] took {time.perf_counter() - t0:.1f} s")

    print("[47] card vs host: Qwen2-VL at one full-width f32 layer; Llama 4 at its smoke "
          "widths, f32")
    t0 = time.perf_counter()
    phase_vlm_card_vs_host()
    print(f"  [47] took {time.perf_counter() - t0:.1f} s")

    print(f"[48] federated training: {VLM_ARCH} at its published widths, f32, remat off and "
          f"on, and the deepest depth each trains; make_round_step on both smoke configs")
    t0 = time.perf_counter()
    trained = phase_vlm_training()
    bwd_launches = {
        "group 7": trained["remat on"]["launches"]["flash_attention_bwd"]
        + trained["remat off"]["launches"]["flash_attention_bwd"],
        "group 5": sum(v["flash_attention_bwd"] for k, v in trained.items()
                       if k.startswith("l4 smoke")),
    }
    bwd_launches["qwen2-vl training"] = bwd_launches["group 7"]
    for name, timed in shapes["bwd_timed"].items():
        rows.append({"name": f"flash_attention_bwd ({name})", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                     "replaces": "src/repro/models/layers.py:154",
                     "launches": bwd_launches[name], **timed})
    print(f"  [48] took {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# [49]-[53]: Zamba2-1.2B and xLSTM-350M, served and trained
# ---------------------------------------------------------------------------

ZAMBA_ARCH, XLSTM_ARCH = "zamba2_1_2b", "xlstm_350m"
#: [50], [51]: each model whole at its published config, bf16, weights from
#: seed ``SEED``; 4 prompts of 1,024 tokens (4 of xLSTM's mLSTM chunks of
#: 256), then 32 greedy steps
REC_BATCH, REC_PROMPT, REC_GEN = 4, 1024, 32
#: [49]'s cases at Zamba2's attention shape (H = KV = 32, hd 64: MHA):
#: K3 at its prefill (B, S, H), K4 at its step (B, H, slots), K3's backward
#: at its training shape ([53] (a): cohort 8 x 512 tokens; f32)
ZAMBA_HD = 64
ZAMBA_K3_CASE = ("zamba2 prefill", REC_BATCH, REC_PROMPT, 32)
ZAMBA_K4_CASE = ("zamba2 step", REC_BATCH, 32, REC_PROMPT + REC_GEN)
ZAMBA_BWD_CASE = ("zamba2 training", (8, 512, 32, 32, ZAMBA_HD))
#: [52]: card against host at full width, f32: Zamba2's first 6 layers (one
#: attention site) and xLSTM's first 8 (m m m m s m m m); 1 x 256 tokens,
#: 8 steps; [11]'s bound for long f32 dot products
REC_HOST_LAYERS = {ZAMBA_ARCH: 6, XLSTM_ARCH: 8}
REC_HOST_PROMPT, REC_HOST_GEN, REC_HOST_TOL = 256, 8, 1e-4
#: [53] (a): both models at their published widths in f32, remat on; at 512
#: tokens both scans carry their state across two chunks of 256
REC_TRAIN = dict(clients=256, cohort=8, seq=512, zipf_a=1.3)
REC_TRAIN_ROUNDS = 2
#: [53] (b): xLSTM's smoke steps are held to the nearest of the host's step
#: and this many steps from its inputs nudged by 2^-24. Its step is
#: discontinuous: where |n . q| < 1 the mLSTM's output scales with exp(-m),
#: its stabiliser m a max over the keys' log weights (the sLSTM's likewise
#: past max(n, 1)), so the gradient jumps where two of them tie within
#: rounding. On an H100 its step 2 once parted card from host by 0.0038040,
#: where the host's own first nudge parted by 0.0038039: the same jump
REC_STEP_BAND = 4


def phase_rec_shapes(rng) -> dict:
    """[49] K3 (bf16), K4 (bf16 and f32) and K3's backward (f32, cluster 1:
    a GQA group of 1) at Zamba2's attention shapes against their plain
    versions; the backward also timed beside SDPA's
    (``train_attention_timing``). Returns the worst errors and the
    backward's timing."""
    worst = {"k3": 0.0, "k4": 0.0, "bwd": 0.0}
    hd = ZAMBA_HD
    name, b, s, h = ZAMBA_K3_CASE
    dtype = torch.bfloat16
    q, k, v = (normal(rng, (b, s, h, hd), dtype) for _ in range(3))
    worst["k3"] = compare(f"flash_attention[{name}]", flash_attention(q, k, v),
                          flash_attention_torch(q, k, v), dtype)
    print(f"  K3 {name:16s} {str(dtype):14s} B={b} S={s} H=KV={h} hd={hd} causal "
          f"max_abs_err={worst['k3']:.3g}")
    del q, k, v
    name, b, h, slots = ZAMBA_K4_CASE
    kpos = cache_slot_positions(slots, slots, False, DEV)
    for dtype in (torch.bfloat16, torch.float32):
        q = normal(rng, (b, h, hd), dtype)
        kc, vc = normal(rng, (b, h, slots, hd), dtype), normal(rng, (b, h, slots, hd), dtype)
        err = compare(f"flash_decode[{name}]", flash_decode(q, kc, vc, kpos, slots - 1).float(),
                      flash_decode_torch(q, kc, vc, kpos, slots - 1).float(), dtype)
        worst["k4"] = max(worst["k4"], err)
        print(f"  K4 {name:16s} {str(dtype):14s} B={b} H=KV={h} S={slots} hd={hd} "
              f"max_abs_err={err:.3g}")
    name, shape = ZAMBA_BWD_CASE
    cluster = bwd_cluster(shape[2], shape[3])
    check(cluster == 1, f"{name}: cluster {cluster}, want 1 (a GQA group of 1)")
    fwd, bwd = train_attention_timing(shape, SEED + 49, name)
    worst["k3"] = max(worst["k3"], fwd["max_abs_err"])
    worst["bwd"] = bwd["max_abs_err"]
    return {**worst, "bwd_timed": bwd}


def rec_step_bytes(cfg, params, cache) -> tuple:
    """What a decode step must read and write, in bytes: (weights, state).
    Weights: every parameter but the embedding table, Zamba2's shared block
    once per site. State: the recurrent states read and written (Zamba2's
    SSM and conv states; xLSTM's matrix memories, normalisers and
    stabilisers) and, for Zamba2, the sites' K and V caches read."""
    size = lambda t: t.numel() * t.element_size()                        # noqa: E731
    weights = sum(size(p) for name, p in params.named_parameters() if name != "embedding")
    if cfg.family == "hybrid":
        shared = sum(size(p) for p in params.shared_attn.parameters())
        weights += (zamba.num_attn_sites(cfg) - 1) * shared
        state = 2 * (size(cache.ssm_state) + size(cache.conv_state)) + size(cache.k) + size(
            cache.v)
    else:
        state = 2 * sum(size(t) for run in cache.m_states + cache.s_states for t in run)
    return weights, state


def phase_rec_serve(arch: str, label: str) -> dict:
    """[50] / [51]: ``arch`` whole at its published config (bf16, weights
    from seed ``SEED``) through ``launch.serve``: for Zamba2 an untimed run
    first records one K3 and one K4 input set; then the timed run with the
    counts set to 0 just before; then where a step's time goes."""
    cfg = get_config(arch)
    b, prompt, gen = REC_BATCH, REC_PROMPT, REC_GEN
    hybrid = cfg.family == "hybrid"
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    shape = (f"{cfg.num_layers} Mamba2 layers, the shared attention block after every "
             f"{cfg.attn_every} ({zamba.num_attn_sites(cfg)} sites; H = KV = {cfg.num_heads}, "
             f"hd {cfg.head_dim}, d_ff {cfg.d_ff}), ssm heads {cfg.ssm_heads}, state "
             f"{cfg.ssm_state}" if hybrid else
             f"{len(cfg.block_pattern)} blocks {''.join(cfg.block_pattern)} "
             f"({cfg.block_pattern.count('m')} mLSTM, {cfg.block_pattern.count('s')} sLSTM), "
             f"{cfg.ssm_heads} heads, expand {cfg.ssm_expand}")
    print(f"  {cfg.name}: {shape}, d_model {cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{n_params / 1e9:.3f} B params ({cfg.dtype}), random init from seed {SEED} in "
          f"{init_s:.1f} s; reduced: none")
    captured = capture_attention_inputs(cfg, params, b, prompt, gen) if hybrid else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_decode.launches = 0
    res = serve_mod.serve(cfg, batch=b, prompt=prompt, gen=gen, device=DEV, seed=SEED,
                          params=params)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    sites = zamba.num_attn_sites(cfg) if hybrid else 0
    check(res.launches_prefill == {"flash_attention": sites, "flash_decode": 0,
                                   "flash_decode_lse": 0},
          f"{label}: prefill launches {res.launches_prefill}, want {sites} of K3")
    check(res.launches_decode == {"flash_attention": 0, "flash_decode": sites * gen,
                                  "flash_decode_lse": 0},
          f"{label}: decode launches {res.launches_decode}, want {sites} of K4 a step")
    check(launches == {"flash_attention": sites, "flash_decode": sites * gen},
          f"{label}: serving run launches {launches}")
    check(res.cache_pos == prompt + gen, f"{label}: the cache is at {res.cache_pos}")
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits),
          f"{label}: non-finite logits")
    check(all(lg.shape == (b, cfg.vocab_size) for lg in res.logits), f"{label}: logits shape")
    cache = build_model(cfg).init_cache(b, prompt + gen, DEV)
    weight_bytes, state_bytes = rec_step_bytes(cfg, params, cache)
    del cache
    bound_ms = roofline(weight_bytes + state_bytes, 0)[0]
    print(f"  prefill {b} x {prompt}: {res.prefill_ms:.1f} ms; decode {gen} steps: "
          f"{res.decode_ms_per_token:.2f} ms/step, {res.tok_per_s:.1f} tok/s; peak memory "
          f"{peak / 1e9:.2f} GB; launches: prefill {res.launches_prefill}, decode "
          f"{res.launches_decode}")
    print(f"  decode step against its read bound: {res.decode_ms_per_token:.2f} ms against "
          f"{bound_ms:.3f} ms ({weight_bytes / 1e9:.3f} GB of weights"
          + (" with the shared block at each site" if hybrid else "")
          + f", {state_bytes / 1e9:.3f} GB of state at {HW['hbm_bandwidth'] / 1e12:.2f} TB/s; "
          f"{res.decode_ms_per_token / bound_ms:.1f}x)")
    print(f"  card: {card_line()}")
    print(f"  greedy tokens of sequence 0: {res.tokens[0][:16].tolist()}")
    out = {"params": n_params, "prefill_ms": res.prefill_ms,
           "decode_ms_per_token": res.decode_ms_per_token, "tok_per_s": res.tok_per_s,
           "peak_gb": peak / 1e9, "launches": launches, "decode_bound_ms": bound_ms,
           "captured": captured}
    out["decode_profile"] = phase_decode_profile(
        params, res.decode_ms_per_token, cfg, b, prompt, gen, n=3,
        read_bytes=weight_bytes + state_bytes, split_target_us=None, label=label,
        k4_per_step=sites)
    del params
    torch.cuda.empty_cache()
    return out


def phase_rec_card_vs_host() -> dict:
    """[52] card against host from the same weights, at full width in f32:
    Zamba2's first 6 layers (one attention site) and xLSTM's first 8 (m m m
    m s m m m) through ``launch.serve``, 1 x ``REC_HOST_PROMPT`` tokens and
    ``REC_HOST_GEN`` steps; logits within ``REC_HOST_TOL``, greedy tokens
    identical."""
    out = {}
    for arch in (ZAMBA_ARCH, XLSTM_ARCH):
        n = REC_HOST_LAYERS[arch]
        cfg = get_config(arch).replace(num_layers=n, dtype="float32")
        if cfg.family == "ssm":
            cfg = cfg.replace(block_pattern=cfg.block_pattern[:n])
        api = build_model(cfg)
        card = api.init(torch.Generator(device=DEV).manual_seed(SEED), DEV)
        host = api.init(device="cpu", state={k: v.cpu() for k, v in card.state_dict().items()})
        kw = dict(batch=1, prompt=REC_HOST_PROMPT, gen=REC_HOST_GEN, seed=SEED)
        rc = serve_mod.serve(cfg, device=DEV, params=card, **kw)
        t0 = time.perf_counter()
        rh = serve_mod.serve(cfg, device="cpu", params=host, **kw)
        host_s = time.perf_counter() - t0
        sites = zamba.num_attn_sites(cfg) if cfg.family == "hybrid" else 0
        check(rc.launches_prefill["flash_attention"] == sites
              and rc.launches_decode["flash_decode"] == sites * REC_HOST_GEN,
              f"[52] {arch}: card launches {rc.launches_prefill}, {rc.launches_decode}")
        check(sum(rh.launches_prefill.values()) + sum(rh.launches_decode.values()) == 0,
              f"[52] {arch}: the host run launched a kernel")
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(rc.logits, rh.logits))
        check(all(torch.allclose(a.cpu(), b, rtol=REC_HOST_TOL, atol=REC_HOST_TOL)
                  for a, b in zip(rc.logits, rh.logits)),
              f"[52] {arch}: card and host logits differ by {err}")
        check(torch.equal(rc.tokens.cpu(), rh.tokens), f"[52] {arch}: card and host tokens "
              "differ")
        layout = (f"{sites} attention site" if cfg.family == "hybrid"
                  else f"blocks {''.join(cfg.block_pattern)}")
        print(f"  {cfg.name}: {n} layers ({layout}) x d_model {cfg.d_model}, f32, 1 x "
              f"{REC_HOST_PROMPT} tokens, {REC_HOST_GEN} steps: max |logit diff| {err:.3g} "
              f"(tolerance {REC_HOST_TOL}); tokens identical {rc.tokens[0].tolist()}; host run "
              f"{host_s:.1f} s")
        out[arch] = err
        del card, host, rc, rh
        torch.cuda.empty_cache()
    return out


def host_spread(step, before: dict, after: dict, batch: dict, seed: int = SEED) -> tuple:
    """How far the host's own step moves when its parameters move by f32's
    unit roundoff: the largest |parameter| gap between ``after`` (the step
    from ``before``) and the step from ``before`` times (1 + 2^-24 N(0, 1)),
    elementwise, from ``seed``; and that nudged step's parameters."""
    gen = torch.Generator().manual_seed(seed)
    nudged = {k: v * (1 + 2.0 ** -24 * torch.randn(v.shape, generator=gen))
              for k, v in before.items()}
    moved, _ = step(nudged, batch)
    return max(float((moved[k] - after[k]).abs().max()) for k in after), moved


def phase_rec_training() -> dict:
    """[53] (a) each model at its published widths in f32 through
    ``launch.train.train`` (``make_lm_federated(256 clients, 512 tokens,
    zipf 1.3)``, cohort 8, lr ``LM_LR``, remat on), the counts set to 0 just
    before each run: Zamba2's K3 twice a site and round (the forward and
    remat's recompute), its backward once; xLSTM none; K1 none. (b)
    ``make_round_step`` on both smoke configs in ``sparse_replicated`` mode,
    card against host step by step: each host step starts from the card's
    parameters before that step. These runs are chaotic at lr ``LM_LR`` (on
    the host alone, two runs that differ only in their threads' sum order
    part by ~1e-6 after the first step, 5e-4 after the second and 0.24
    after the third for xLSTM), so a whole trajectory is no test of the
    card. Nor is 1e-5 on a step's parameters: the step scales a cold row's
    gradient by N / n_m = 64, so each update is computed to ~1e-4 of its
    size, and on the host alone a 2^-24 nudge of the step's inputs moves
    xLSTM's parameters by 6.6e-5 (``host_spread``, printed). Each step: the
    loss within ``LM_STEP_TOL``; each leaf's update within ``LM_UPDATE_TOL``
    in relative norm ([36]'s bound) and each parameter within
    ``LM_STEP_TOL`` plus ``LM_UPDATE_TOL`` of the leaf's largest update
    element; xLSTM's of the nearest of the host's step and ``REC_STEP_BAND``
    nudged ones. K1 once a step, held to its plain version on the last
    step's inputs."""
    out = {}
    for arch in (ZAMBA_ARCH, XLSTM_ARCH):
        cfg = get_config(arch).replace(dtype="float32")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        lm_zero_counts()
        res = train_mod.train(cfg, rounds=REC_TRAIN_ROUNDS, lr=LM_LR, device=DEV,
                              log_every=0, remat=True, **REC_TRAIN)
        launches = lm_counts()
        peak = torch.cuda.max_memory_allocated()
        n = (zamba.num_attn_sites(cfg) if cfg.family == "hybrid" else 0) * REC_TRAIN_ROUNDS
        want = {"flash_attention": 2 * n, "flash_attention_bwd": n, "union_segsum": 0}
        check(launches == want, f"[53] (a) {arch}: launches {launches}, want {want}")
        check(all(math.isfinite(x) for x in res.losses), f"[53] (a) {arch}: loss not finite")
        steady = statistics.median(res.ms_per_round[1:])
        n_params = sum(p.numel() for p in res.params.values())
        print(f"  (a) {cfg.name}: {n_params / 1e9:.3f} B params (f32), {REC_TRAIN}, lr "
              f"{LM_LR}, remat on; reduced: none. loss {[round(x, 5) for x in res.losses]}; "
              f"ms/round: first {res.ms_per_round[0]:.1f}, steady {steady:.1f} (median of "
              f"rounds 2-{REC_TRAIN_ROUNDS}); peak device memory {peak / 1e9:.2f} GB; "
              f"launches {launches}")
        out[arch] = {"losses": res.losses, "ms_per_round": res.ms_per_round,
                     "steady_ms_per_round": steady, "peak_gb": peak / 1e9,
                     "launches": launches}
        del res
    torch.cuda.empty_cache()

    out["k1_err"] = 0.0
    for arch in (ZAMBA_ARCH, XLSTM_ARCH):
        got = smoke_steps_card_vs_host(get_smoke_config(arch).replace(dtype="float32"),
                                       "sparse_replicated", "[53] (b)",
                                       band=REC_STEP_BAND if arch == XLSTM_ARCH else 0)
        out["k1_err"] = max(out["k1_err"], got["k1_err"])
        out[f"{arch} smoke"] = {"launches": got["launches"]}
    return out


def smoke_steps_card_vs_host(cfg, mode: str, label: str, extra=None, steps: int = 3,
                             cohort: int = 4, clients: int = 64, band: int = 0) -> dict:
    """``make_round_step`` in ``mode`` on ``cfg`` (a smoke config, f32), card
    against host step by step ([53] (b)): each host step starts from the
    card's parameters before that step; the loss within ``LM_STEP_TOL``,
    each leaf's update within ``LM_UPDATE_TOL`` in relative norm and each
    parameter within ``LM_STEP_TOL`` plus ``LM_UPDATE_TOL`` of the leaf's
    largest update element. With ``band``, each parameter is held to that
    tolerance of the nearest of the host's step and ``band`` steps from its
    inputs nudged by 2^-24 (``host_spread``, seeds ``SEED`` on), and each
    leaf's update to the nearest of their updates: where a step is
    discontinuous, each side of the jump is the host's own answer.
    ``extra(lead)`` gives numpy leaves to add to a
    batch whose tokens lead with the axes ``lead``. On a ``sparse`` mode K1
    once a step, held to its plain version on the last step's inputs; on a
    dense one none. Returns the launches and K1's error."""
    ds = make_lm_federated(num_clients=clients, vocab=cfg.vocab_size, seq_len=64,
                           samples_per_client=4, zipf_a=LM_CORPUS["zipf_a"])
    batches = lm_step_batches(ds, cohort, steps, stacked=mode != "fedsgd")
    for b in batches:
        b.update(extra(b["tokens"].shape[:-1]) if extra else {})
    params, axes = lm_params(cfg, DEV)
    api = build_model(cfg)
    fed = FedConfig(num_clients=clients, clients_per_round=cohort, local_iters=2,
                    lr=LM_LR, algorithm="fedsubavg")
    card_step = make_round_step(api.loss, params, axes, fed, mode=mode)
    host_step = make_round_step(api.loss, {k: v.cpu() for k, v in params.items()}, axes,
                                fed, mode=mode)
    captured, losses, lines = {}, [], []
    lm_zero_counts()
    for i, b in enumerate(batches):
        before = {k: v.to("cpu", copy=True) for k, v in params.items()}
        hb = {k: torch.from_numpy(v) for k, v in b.items()}
        with capture_k1(captured):
            params, m = card_step(params, {k: v.to(DEV) for k, v in hb.items()})
        launches = lm_counts()
        h_params, hm = host_step({k: v.clone() for k, v in before.items()}, hb)
        runs, spreads = [h_params], []
        for j in range(max(band, 1)):
            spread, moved = host_spread(host_step, before, h_params, hb, SEED + j)
            spreads.append(spread)
            if band:
                runs.append(moved)
        spread = spreads[0]
        check(lm_counts() == launches, f"{label} {cfg.name}: the host step launched a kernel")
        losses.append(float(m["loss"]))
        check(math.isclose(losses[-1], float(hm["loss"]), rel_tol=LM_STEP_TOL,
                           abs_tol=LM_STEP_TOL),
              f"{label} {cfg.name}: card loss {losses[-1]} against host {float(hm['loss'])}")
        card = {k: params[k].cpu() for k in h_params}
        step_err = max(float((card[k] - h_params[k]).abs().max()) for k in h_params)
        # each element's distance to the nearest of the host's runs
        near = {k: torch.stack([(card[k] - run[k]).abs() for run in runs]).amin(0)
                for k in h_params}
        band_err = max(float(near[k].max()) for k in h_params)
        band_line = (f", {band_err} from the nearest of it and its {band} nudged steps"
                     if band else "")
        check(all(bool((near[k] <= LM_STEP_TOL + LM_UPDATE_TOL
                        * float((h_params[k] - before[k]).abs().max())).all())
                  for k in h_params),
              f"{label} {cfg.name} step {i}: card and host parameters differ by "
              f"{step_err}{band_line}, the host's own spread {spreads}")
        # the mLSTM's input-gate bias has an exact gradient of 0 (the
        # stabilised cell is invariant to a per-head shift of log i): its
        # update is rounding noise on either side, held by the parameters.
        # Each leaf's update against the nearest of the host's runs
        upd = max(min(float(torch.linalg.vector_norm((card[k] - run[k]).double())
                            / torch.linalg.vector_norm((run[k] - before[k]).double())
                            .clamp(min=1e-30)) for run in runs) for k in h_params
                  if not (torch.equal(h_params[k], before[k]) or k.endswith(".b_i")))
        check(upd <= LM_UPDATE_TOL, f"{label} {cfg.name} step {i}: an update differs by {upd} "
              "in relative norm")
        spread_line = (f"nudged steps' spreads {[float(f'{x:.3g}') for x in spreads]}, "
                       f"nearest {band_err:.3g}" if band else f"host's own spread {spread:.3g}")
        lines.append(f"step {i}: |param diff| {step_err:.3g} ({spread_line}), update "
                     f"{upd:.3g} in relative norm")
        del runs, near
    sparse = "sparse" in mode
    check(launches["union_segsum"] == (steps if sparse else 0),
          f"{label} {cfg.name}: K1 launched {launches['union_segsum']} times in {steps} steps")
    k1_err, k1_line = 0.0, "no K1"
    if sparse:
        args = captured["args"]
        ids, v = args[0], args[5]
        union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
        k1_err = check_k1(f"union_segsum[{cfg.name} {mode} step]", args,
                          captured["kw"]["scale"], union)
        k1_line = f"K1 at the last step V={v} T={ids.numel()} union={union} " \
                  f"max_abs_err={k1_err:.3g}"
    held = f" of the nearest of the host's step and {band} nudged ones" if band else ""
    print(f"  {label} {cfg.name} {mode}, {steps} steps: loss "
          f"{[round(x, 4) for x in losses]}, launches {launches}; {k1_line}; card against "
          f"host, step by step (parameters within {LM_STEP_TOL} + {LM_UPDATE_TOL} of the "
          f"update{held}, updates within {LM_UPDATE_TOL} in relative norm): "
          + "; ".join(lines))
    del params, h_params
    return {"launches": launches, "k1_err": k1_err}


def phase_rec_slice(kernels: list, rng) -> list:
    """[49]-[53], each timed; adds [49]'s errors to K3's, K4's and K3
    backward's entries and returns this slice's rows of the kernels line."""
    print("[49] K3, K4 and K3's backward vs plain versions at Zamba2's attention shape "
          "(H = KV = 32, hd 64)")
    t0 = time.perf_counter()
    shapes = phase_rec_shapes(rng)
    by_name = {e["name"]: e for e in kernels}
    for name, key in (("flash_attention", "k3"), ("flash_decode", "k4"),
                      ("flash_attention_bwd", "bwd")):
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], shapes[key])
    print(f"  [49] took {time.perf_counter() - t0:.1f} s")

    print(f"[50] serving path: {ZAMBA_ARCH} at its published config, {REC_BATCH} x "
          f"{REC_PROMPT} prompts, {REC_GEN} steps")
    t0 = time.perf_counter()
    served = phase_rec_serve(ZAMBA_ARCH, "[50]")
    rows = attention_timing(served.pop("captured"), served["launches"], shapes["k3"],
                            shapes["k4"], names=("flash_attention (zamba2 prefill)",
                                                 "flash_decode (zamba2 step)"),
                            k3_target_ms=None)
    print(f"  [50] took {time.perf_counter() - t0:.1f} s")

    print(f"[51] serving path: {XLSTM_ARCH} at its published config, {REC_BATCH} x "
          f"{REC_PROMPT} prompts, {REC_GEN} steps (no repo kernel on its path)")
    t0 = time.perf_counter()
    phase_rec_serve(XLSTM_ARCH, "[51]")
    print(f"  [51] took {time.perf_counter() - t0:.1f} s")

    print("[52] card vs host at full width, f32: Zamba2's first 6 layers, xLSTM's first 8")
    t0 = time.perf_counter()
    phase_rec_card_vs_host()
    print(f"  [52] took {time.perf_counter() - t0:.1f} s")

    print(f"[53] federated training: both models at their published widths, f32, remat on, "
          f"{REC_TRAIN_ROUNDS} rounds; make_round_step sparse_replicated on both smoke "
          f"configs, card vs host")
    t0 = time.perf_counter()
    trained = phase_rec_training()
    by_name["union_segsum"]["max_abs_err"] = max(by_name["union_segsum"]["max_abs_err"],
                                                 trained["k1_err"])
    by_name["union_segsum"].setdefault("launches_by_path", {}).update({
        f"{arch} smoke make_round_step sparse_replicated":
            trained[f"{arch} smoke"]["launches"]["union_segsum"]
        for arch in (ZAMBA_ARCH, XLSTM_ARCH)})
    rows.append({"name": "flash_attention_bwd (zamba2 training)", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 "replaces": "src/repro/models/layers.py:154",
                 "launches": trained[ZAMBA_ARCH]["launches"]["flash_attention_bwd"],
                 **shapes["bwd_timed"]})
    print(f"  [53] took {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# [54]-[58]: Whisper large-v3, served and trained
# ---------------------------------------------------------------------------

WH_ARCH = "whisper_large_v3"
#: [55]: the whole model in bf16, weights from seed ``SEED``; 4 requests of
#: 30 s of audio (1,500 frames) and a 224-token prompt (half the decoder's
#: 448-token context, the longest previous-text prompt Whisper's decoding
#: takes), then 32 greedy steps
WH_BATCH, WH_PROMPT, WH_GEN = 4, 224, 32
WH_PARAMS = 2_020_789_760
#: [54]'s K3 cases at [55]'s prefill (name, B, Sq, Sk, causal), H = KV = 20,
#: hd 64: the encoder, cross-attention to the frames, the decoder
WH_K3_CASES = (("whisper encoder", WH_BATCH, 1500, 1500, False),
               ("whisper cross-attention", WH_BATCH, WH_PROMPT, 1500, False),
               ("whisper decoder", WH_BATCH, WH_PROMPT, WH_PROMPT, True))
#: [54]'s K4 cases at [55]'s last step (name, B, slots): the self-attention
#: cache, every slot written, and the frames' cache, every slot valid
WH_K4_CASES = (("whisper self step", WH_BATCH, WH_PROMPT + WH_GEN),
               ("whisper cross step", WH_BATCH, 1500))
#: [57]: the corpus, cohort and rounds; [54]'s backward cases at its shapes
#: (name, Sq, Sk, causal), B = the cohort
WH_TRAIN = dict(clients=256, cohort=8, seq=448, zipf_a=1.3)
WH_TRAIN_ROUNDS = 3
WH_BWD_CASES = (("whisper encoder training", 1500, 1500, False),
                ("whisper cross-attention training", WH_TRAIN["seq"], 1500, False),
                ("whisper decoder training", WH_TRAIN["seq"], WH_TRAIN["seq"], True))
#: [56]: layers on each side, prompt, steps; [11]'s bound
WH_HOST_LAYERS, WH_HOST_PROMPT, WH_HOST_GEN, WH_HOST_TOL = 2, 64, 8, 1e-4


@contextlib.contextmanager
def attention_tally():
    """Counts the calls that reach K3, its backward and K4 while it is open,
    by shape: ``("k3" | "bwd", Sq, Sk, causal)`` and ``("k4", slots)``. On
    the card each such call launches its kernel; the kernels' own counters
    are untouched. The wrappers are ``FlashAttention``'s and
    ``FlashAttentionBackward``'s forwards and ``layers``' name for K4, as
    ``capture_attention_inputs`` wraps them."""
    tally: dict = {}
    k3_forward, bwd_forward = FlashAttention.forward, FlashAttentionBackward.forward

    def add(key):
        tally[key] = tally.get(key, 0) + 1

    def count_k3(q, k, v, causal, window, q_offset, query_chunk, kv_chunk, need_lse=True):
        add(("k3", q.shape[1], k.shape[1], bool(causal)))
        return k3_forward(q, k, v, causal, window, q_offset, query_chunk, kv_chunk, need_lse)

    def count_bwd(q, k, v, out, dout, lse, causal, window, q_offset):
        add(("bwd", q.shape[1], k.shape[1], bool(causal)))
        return bwd_forward(q, k, v, out, dout, lse, causal, window, q_offset)

    def count_k4(q, k_cache, *args, **kw):
        add(("k4", k_cache.shape[2]))
        return flash_decode(q, k_cache, *args, **kw)

    FlashAttention.forward = staticmethod(count_k3)
    FlashAttentionBackward.forward = staticmethod(count_bwd)
    layers_mod.flash_decode = count_k4
    try:
        yield tally
    finally:
        FlashAttention.forward = staticmethod(k3_forward)
        FlashAttentionBackward.forward = staticmethod(bwd_forward)
        layers_mod.flash_decode = flash_decode


def wh_frames(cfg, batch: int, seed: int = SEED) -> torch.Tensor:
    """Frame embeddings ``(batch, encoder_seq, d)``, N(0, 1) from a numpy
    seed, in the model's dtype, on the card."""
    x = np.random.default_rng(seed).standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return torch.from_numpy(x).to(DEV, transformer.model_dtype(cfg))


def wh_k3_timing(q, k, v, causal: bool, name: str) -> dict:
    """K3 on ``q, k, v`` held to its plain version, then timed by CUDA
    events beside it (plain, kernel, kernel, plain), SDPA on the same
    inputs (heads laid out and repeated outside the timed call) and the
    bound over the valid (query, key) pairs."""
    import torch.nn.functional as F

    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    err = compare(f"flash_attention[{name}]", flash_attention(q, k, v, causal=causal).float(),
                  flash_attention_torch(q, k, v, causal=causal).float(), q.dtype)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous()
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)  # noqa: E731
    k3 = lambda: flash_attention(q, k, v, causal=causal)                      # noqa: E731
    plain = lambda: flash_attention_torch(q, k, v, causal=causal)             # noqa: E731
    p1, m1, m2, p2 = cuda_ms(plain, 3, 1), cuda_ms(k3, 20), cuda_ms(k3, 20), cuda_ms(plain, 3, 1)
    lib_ms = cuda_ms(lib, 20)
    backend = sdpa_backend(lib)
    pairs = sq * (sq + 1) // 2 if causal else sq * sk
    cost = cost_model("flash_attention", b=b, sq=sq, h=h, kv=kvh, hd=hd, keys=sk, pairs=pairs,
                      dtype=q.dtype)
    ops, bound_ms, by = cost.flops, cost.bound_ms, cost.bound_by
    ms = min(m1, m2)
    print(f"  K3 {name} B={b} Sq={sq} Sk={sk} H={h} KV={kvh} hd={hd} {q.dtype} "
          f"{'causal' if causal else 'non-causal'}: max_abs_err {err:.3g}; kernel {m1:.4f}/"
          f"{m2:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s), plain {p1:.4f}/{p2:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms ({backend}; {ops / lib_ms / 1e9:.1f} TFLOP/s), bound {bound_ms:.5f} "
          f"ms ({by})")
    return {"shape": [b, sq, sk, h, kvh, hd], "causal": causal, "dtype": str(q.dtype),
            "max_abs_err": err, "ms": ms, "plain_ms": min(p1, p2), "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms, "library": f"SDPA, {backend}"}


def wh_k4_timing(q, kc, vc, kpos, qpos: int, name: str) -> dict:
    """K4 held to its plain version, then timed as ``wh_k3_timing`` times
    K3, beside SDPA with the slots' mask; the bound reads q and the valid
    slots' K and V once and writes the output."""
    import torch.nn.functional as F

    b, h, hd = q.shape
    kvh = kc.shape[1]
    valid = (kpos >= 0) & (kpos <= qpos)
    n_valid = int(valid.sum())
    err = compare(f"flash_decode[{name}]", flash_decode(q, kc, vc, kpos, qpos).float(),
                  flash_decode_torch(q, kc, vc, kpos, qpos).float(), q.dtype)
    g = h // kvh
    q4, kct, vct = q[:, :, None], kc.repeat_interleave(g, dim=1), vc.repeat_interleave(g, dim=1)
    mask = valid[None, None, None]
    lib = lambda: F.scaled_dot_product_attention(q4, kct, vct, attn_mask=mask)  # noqa: E731
    k4 = lambda: flash_decode(q, kc, vc, kpos, qpos)                           # noqa: E731
    plain = lambda: flash_decode_torch(q, kc, vc, kpos, qpos)                  # noqa: E731
    o1, n1, n2, o2 = cuda_ms(plain), cuda_ms(k4), cuda_ms(k4), cuda_ms(plain)
    lib_ms = cuda_ms(lib)
    backend = sdpa_backend(lib)
    cost = cost_model("flash_decode", b=b, h=h, kv=kvh, hd=hd, n_valid=n_valid,
                      slots=kpos.numel(), dtype=q.dtype)
    nbytes, bound_ms, by = cost.bytes, cost.bound_ms, cost.bound_by
    ms = min(n1, n2)
    print(f"  K4 {name} B={b} H={h} KV={kvh} S={kc.shape[2]} valid={n_valid} hd={hd} "
          f"{q.dtype}: max_abs_err {err:.3g}; kernel {n1:.4f}/{n2:.4f} ms ({nbytes / ms / 1e9:.2f} "
          f"TB/s), plain {o1:.4f}/{o2:.4f} ms, SDPA {lib_ms:.4f} ms ({backend}; "
          f"{nbytes / lib_ms / 1e9:.2f} TB/s), bound {bound_ms:.5f} ms ({by})")
    return {"shape": [b, h, kvh, kc.shape[2], hd], "valid": n_valid, "dtype": str(q.dtype),
            "max_abs_err": err, "ms": ms, "plain_ms": min(o1, o2), "bound_ms": bound_ms,
            "bound_by": by, "library_ms": lib_ms, "library": f"SDPA, {backend}"}


def phase_wh_shapes(rng) -> dict:
    """[54] K3, K4 and K3's backward at Whisper's shapes against their plain
    versions: each K3 and K4 case in bf16 (timed: [55]'s dtype) and f32; K4
    also on the first and the last layer's slice of a stacked cache (the
    last one's end is the allocation's: a tile past it must not be read
    from outside) and on a part-filled self-attention cache; the backward
    in f32 at cluster 1 (a GQA group of 1), timed beside SDPA's. Returns the
    worst errors and the timings by case name."""
    worst = {"k3": 0.0, "k4": 0.0, "bwd": 0.0}
    timed = {}
    h = kv = 20
    hd = 64
    for name, b, sq, sk, causal in WH_K3_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q = normal(rng, (b, sq, h, hd), dtype)
            k, v = normal(rng, (b, sk, kv, hd), dtype), normal(rng, (b, sk, kv, hd), dtype)
            if dtype == torch.bfloat16:
                timed[name] = wh_k3_timing(q, k, v, causal, name)
                err = timed[name]["max_abs_err"]
            else:
                err = compare(f"flash_attention[{name}, f32]",
                              flash_attention(q, k, v, causal=causal),
                              flash_attention_torch(q, k, v, causal=causal), dtype)
                print(f"  K3 {name} B={b} Sq={sq} Sk={sk} H=KV={h} hd={hd} {dtype} "
                      f"{'causal' if causal else 'non-causal'}: max_abs_err {err:.3g}")
            worst["k3"] = max(worst["k3"], err)
            del q, k, v
    for name, b, slots in WH_K4_CASES:
        full = cache_slot_positions(slots, slots, False, DEV)
        for dtype in (torch.bfloat16, torch.float32):
            q = normal(rng, (b, h, hd), dtype)
            kc, vc = normal(rng, (b, kv, slots, hd), dtype), normal(rng, (b, kv, slots, hd), dtype)
            if dtype == torch.bfloat16:
                timed[name] = wh_k4_timing(q, kc, vc, full, slots - 1, name)
                err = timed[name]["max_abs_err"]
            else:
                err = compare(f"flash_decode[{name}, f32]",
                              flash_decode(q, kc, vc, full, slots - 1),
                              flash_decode_torch(q, kc, vc, full, slots - 1), dtype)
                print(f"  K4 {name} B={b} H=KV={h} S={slots} hd={hd} {dtype}: max_abs_err "
                      f"{err:.3g}")
            worst["k4"] = max(worst["k4"], err)
            # the first and the last layer of a stacked (L, B, KV, S, hd) cache
            kst, vst = (normal(rng, (2, b, kv, slots, hd), dtype) for _ in range(2))
            for layer in (0, 1):
                err = compare(f"flash_decode[{name}, layer {layer} of 2, {dtype}]",
                              flash_decode(q, kst[layer], vst[layer], full, slots - 1).float(),
                              flash_decode_torch(q, kst[layer], vst[layer], full,
                                                 slots - 1).float(), dtype)
                worst["k4"] = max(worst["k4"], err)
            # a part-filled cache: the self-attention cache mid-decode
            part = cache_slot_positions(slots - 27, slots, False, DEV)
            err = compare(f"flash_decode[{name}, {slots - 27} of {slots} slots, {dtype}]",
                          flash_decode(q, kc, vc, part, slots - 28).float(),
                          flash_decode_torch(q, kc, vc, part, slots - 28).float(), dtype)
            worst["k4"] = max(worst["k4"], err)
            print(f"  K4 {name} {dtype}: layers 0 and 1 of a stacked cache and {slots - 27} "
                  f"of {slots} slots filled agree with the plain version (worst "
                  f"{worst['k4']:.3g})")
            del q, kc, vc, kst, vst
    for name, sq, sk, causal in WH_BWD_CASES:
        cluster = bwd_cluster(h, kv)
        check(cluster == 1, f"{name}: cluster {cluster}, want 1 (a GQA group of 1)")
        fwd, bwd = train_attention_timing((WH_TRAIN["cohort"], sq, h, kv, hd), SEED + 54, name,
                                          sk=sk, causal=causal)
        worst["k3"] = max(worst["k3"], fwd["max_abs_err"])
        worst["bwd"] = max(worst["bwd"], bwd["max_abs_err"])
        timed[name] = bwd
    return {**worst, "timed": timed}


def wh_step_bytes(cfg, params, batch: int, prompt: int, gen: int) -> tuple:
    """What one decode step must read and write, in bytes, averaged over the
    ``gen`` steps: (weights, caches). Weights: the decoder's but
    cross-attention's ``wk`` and ``wv`` (the frames' K and V are cached),
    the final norm, ``lm_head`` and the step's embedding rows. Caches: the
    frames' K and V, the self-attention cache's valid slots (step i reads
    ``prompt + i + 1``) and the token's K and V written."""
    size = lambda t: t.numel() * t.element_size()                         # noqa: E731
    weights = sum(size(p) for name, p in params.named_parameters()
                  if name.startswith("decoder.")
                  and ".cross_attn.wk." not in name and ".cross_attn.wv." not in name)
    weights += size(params.final_norm.scale) + size(params.lm_head)
    esize = params.lm_head.element_size()
    weights += batch * cfg.d_model * esize
    row = cfg.num_layers * batch * cfg.num_kv_heads * cfg.head_dim * esize * 2   # K and V
    caches = row * (cfg.encoder_seq + prompt + (gen + 1) / 2 + 1)
    return weights, caches


def phase_wh_serve() -> dict:
    """[55] Whisper large-v3 whole through ``launch.serve`` with frames from a
    numpy seed: an untimed request first (the per-shape tally of its K3
    and K4 calls); then the timed one, the counts set to 0 just before;
    the encoder alone by CUDA events; the step against its read bound;
    where a step's and a prefill's time goes."""
    cfg = get_config(WH_ARCH)
    b, prompt, gen = WH_BATCH, WH_PROMPT, WH_GEN
    t0 = time.perf_counter()
    params = build_model(cfg).init(torch.Generator(device=DEV).manual_seed(SEED), DEV)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    check(n_params == WH_PARAMS, f"[55]: {n_params} parameters, want {WH_PARAMS}")
    frames = wh_frames(cfg, b)
    print(f"  {cfg.name}: {cfg.encoder_layers} encoder and {cfg.num_layers} decoder layers, "
          f"d_model {cfg.d_model}, H = KV = {cfg.num_heads}, hd {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.encoder_seq} frames; {n_params:,} params "
          f"({cfg.dtype}), random init from seed {SEED} in {init_s:.1f} s; reduced: none")
    kw = dict(batch=b, prompt=prompt, gen=gen, device=DEV, seed=SEED, params=params,
              frames=frames)
    with attention_tally() as tally:
        serve_mod.serve(cfg, **kw)
    ne, nl = cfg.encoder_layers, cfg.num_layers
    want = {("k3", cfg.encoder_seq, cfg.encoder_seq, False): ne,
            ("k3", prompt, cfg.encoder_seq, False): nl, ("k3", prompt, prompt, True): nl,
            ("k4", prompt + gen): nl * gen, ("k4", cfg.encoder_seq): nl * gen}
    check(tally == want, f"[55]: attention calls by shape {tally}, want {want}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    flash_decode.launches = 0
    res = serve_mod.serve(cfg, **kw)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}
    peak = torch.cuda.max_memory_allocated()
    check(res.launches_prefill == {"flash_attention": ne + 2 * nl, "flash_decode": 0,
                                   "flash_decode_lse": 0},
          f"[55]: prefill launches {res.launches_prefill}, want {ne + 2 * nl} of K3")
    check(res.launches_decode == {"flash_attention": 0, "flash_decode": 2 * nl * gen,
                                  "flash_decode_lse": 0},
          f"[55]: decode launches {res.launches_decode}, want {2 * nl} of K4 a step")
    check(launches == {"flash_attention": ne + 2 * nl, "flash_decode": 2 * nl * gen},
          f"[55]: serving run launches {launches}")
    check(res.cache_pos == prompt + gen, f"[55]: the cache is at {res.cache_pos}")
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits), "[55]: non-finite logits")
    check(all(lg.shape == (b, cfg.vocab_size) for lg in res.logits), "[55]: logits shape")
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: whisper.encode(cfg, params, frames), 3, 1)
    weight_bytes, cache_bytes = wh_step_bytes(cfg, params, b, prompt, gen)
    bound_ms = roofline(weight_bytes + cache_bytes, 0)[0]
    print(f"  prefill {b} x ({cfg.encoder_seq} frames + {prompt} tokens): {res.prefill_ms:.1f} "
          f"ms (host clock), the encoder alone {enc_ms:.2f} ms (CUDA events), the rest "
          f"{res.prefill_ms - enc_ms:.2f} ms; decode {gen} steps: {res.decode_ms_per_token:.2f} "
          f"ms/step, {res.tok_per_s:.1f} tok/s; peak memory {peak / 1e9:.2f} GB; launches: "
          f"prefill {res.launches_prefill}, decode {res.launches_decode}")
    print(f"  decode step against its read bound: {res.decode_ms_per_token:.2f} ms against "
          f"{bound_ms:.3f} ms ({weight_bytes / 1e9:.3f} GB of weights, {cache_bytes / 1e9:.3f} "
          f"GB of caches at {HW['hbm_bandwidth'] / 1e12:.2f} TB/s; "
          f"{res.decode_ms_per_token / bound_ms:.1f}x)")
    print(f"  card: {card_line()}")
    print(f"  greedy tokens of sequence 0: {res.tokens[0][:16].tolist()}")
    inputs = {"frames": frames}
    step = phase_decode_profile(params, res.decode_ms_per_token, cfg, b, prompt, gen, n=3,
                                read_bytes=weight_bytes + cache_bytes, split_target_us=None,
                                label="[55]", inputs=inputs, k4_per_step=2 * nl)
    pre = phase_prefill_profile(params, res.prefill_ms, cfg, b, prompt, inputs=inputs,
                                label="[55]", k3_launches=ne + 2 * nl)
    del params, frames
    torch.cuda.empty_cache()
    return {"tally": tally, "launches": launches, "prefill_ms": res.prefill_ms,
            "encoder_ms": enc_ms, "decode_ms_per_token": res.decode_ms_per_token,
            "tok_per_s": res.tok_per_s, "peak_gb": peak / 1e9, "decode_bound_ms": bound_ms,
            "decode_profile": step, "prefill_profile": pre}


def phase_wh_card_vs_host() -> float:
    """[56] card against host from the same weights: ``WH_HOST_LAYERS``
    encoder and decoder layers at full width, f32, 1 x 1,500 frames,
    ``WH_HOST_PROMPT`` tokens and ``WH_HOST_GEN`` steps through
    ``launch.serve``; logits within ``WH_HOST_TOL``, greedy tokens
    identical."""
    n = WH_HOST_LAYERS
    cfg = get_config(WH_ARCH).replace(num_layers=n, encoder_layers=n, dtype="float32")
    api = build_model(cfg)
    card = api.init(torch.Generator(device=DEV).manual_seed(SEED), DEV)
    host = api.init(device="cpu", state={k: v.cpu() for k, v in card.state_dict().items()})
    frames = wh_frames(cfg, 1, SEED + 56)
    kw = dict(batch=1, prompt=WH_HOST_PROMPT, gen=WH_HOST_GEN, seed=SEED)
    rc = serve_mod.serve(cfg, device=DEV, params=card, frames=frames, **kw)
    t0 = time.perf_counter()
    rh = serve_mod.serve(cfg, device="cpu", params=host, frames=frames.cpu(), **kw)
    host_s = time.perf_counter() - t0
    check(rc.launches_prefill["flash_attention"] == 3 * n
          and rc.launches_decode["flash_decode"] == 2 * n * WH_HOST_GEN,
          f"[56]: card launches {rc.launches_prefill}, {rc.launches_decode}")
    check(sum(rh.launches_prefill.values()) + sum(rh.launches_decode.values()) == 0,
          "[56]: the host run launched a kernel")
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(rc.logits, rh.logits))
    check(all(torch.allclose(a.cpu(), b, rtol=WH_HOST_TOL, atol=WH_HOST_TOL)
              for a, b in zip(rc.logits, rh.logits)),
          f"[56]: card and host logits differ by {err}")
    check(torch.equal(rc.tokens.cpu(), rh.tokens), "[56]: card and host tokens differ")
    print(f"  {n} encoder + {n} decoder layers x d_model {cfg.d_model}, f32, 1 x "
          f"{cfg.encoder_seq} frames, {WH_HOST_PROMPT} tokens, {WH_HOST_GEN} steps: max |logit "
          f"diff| {err:.3g} (tolerance {WH_HOST_TOL}); tokens identical {rc.tokens[0].tolist()}; "
          f"host run {host_s:.1f} s")
    del card, host
    torch.cuda.empty_cache()
    return err


def phase_wh_training() -> dict:
    """[57] Whisper large-v3 at its published widths, whole, in f32 through
    ``launch.train.train`` with remat (``WH_TRAIN``, lr ``LM_LR``), every
    round's batch with the same frames from a numpy seed; the counts set to
    0 just before: K3 twice for each of a round's 96 attention uses (the
    forward and remat's recompute, the encoder's always and the decoder's
    under ``remat``), its backward once each, K1 none; the calls tallied by
    shape. Losses finite."""
    cfg = get_config(WH_ARCH).replace(dtype="float32")
    frames = wh_frames(cfg, WH_TRAIN["cohort"], SEED + 57)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lm_zero_counts()
    with attention_tally() as tally:
        res = train_mod.train(cfg, rounds=WH_TRAIN_ROUNDS, lr=LM_LR, device=DEV, log_every=0,
                              remat=True, inputs={"frames": frames}, **WH_TRAIN)
    launches = lm_counts()
    peak = torch.cuda.max_memory_allocated()
    r, s, e = WH_TRAIN_ROUNDS, WH_TRAIN["seq"], cfg.encoder_seq
    ne, nl = cfg.encoder_layers, cfg.num_layers
    uses = ne + 2 * nl
    want = {"flash_attention": 2 * uses * r, "flash_attention_bwd": uses * r, "union_segsum": 0}
    check(launches == want, f"[57]: launches {launches}, want {want}")
    want_tally = {("k3", e, e, False): 2 * ne * r, ("k3", s, e, False): 2 * nl * r,
                  ("k3", s, s, True): 2 * nl * r, ("bwd", e, e, False): ne * r,
                  ("bwd", s, e, False): nl * r, ("bwd", s, s, True): nl * r}
    check(tally == want_tally, f"[57]: attention calls by shape {tally}, want {want_tally}")
    check(all(math.isfinite(x) for x in res.losses), "[57]: loss not finite")
    steady = statistics.median(res.ms_per_round[1:])
    n_params = sum(p.numel() for p in res.params.values())
    check(n_params == WH_PARAMS, f"[57]: {n_params} parameters, want {WH_PARAMS}")
    print(f"  {cfg.name}: {n_params:,} params (f32), {WH_TRAIN}, frames ({WH_TRAIN['cohort']}, "
          f"{e}, {cfg.d_model}), lr {LM_LR}, remat on; reduced: none. loss "
          f"{[round(x, 5) for x in res.losses]}; ms/round: first {res.ms_per_round[0]:.1f}, "
          f"steady {steady:.1f} (median of rounds 2-{r}); peak device memory "
          f"{peak / 1e9:.2f} GB; launches {launches}")
    print(f"  card: {card_line()}")
    out = {"losses": res.losses, "ms_per_round": res.ms_per_round, "steady_ms_per_round": steady,
           "peak_gb": peak / 1e9, "launches": launches, "tally": tally}
    del res, frames
    torch.cuda.empty_cache()
    return out


def phase_wh_steps() -> dict:
    """[58] the Whisper smoke model's ``make_round_step`` with frames (from a
    numpy seed, shaped as each batch's tokens) under ``fedsgd`` and
    ``sparse_replicated``, card against host step by step as [53] (b)."""
    cfg = get_smoke_config(WH_ARCH).replace(dtype="float32")
    rng = np.random.default_rng(SEED + 58)

    def frames(lead):
        return {"frames": rng.standard_normal(tuple(lead) + (cfg.encoder_seq, cfg.d_model),
                                              dtype=np.float32)}

    return {mode: smoke_steps_card_vs_host(cfg, mode, "[58]", extra=frames)
            for mode in ("fedsgd", "sparse_replicated")}


def phase_whisper_slice(kernels: list, rng) -> list:
    """[54]-[58], each timed; adds [54]'s errors to K3's, K4's and K3
    backward's entries and [58]'s K1 to K1's, and returns this slice's rows
    of the kernels line: K3 and K4 at [55]'s shapes and K3's backward at
    [57]'s, each with its launches on that path."""
    by_name = {e["name"]: e for e in kernels}
    print("[54] K3, K4 and K3's backward vs plain versions at Whisper large-v3's shapes "
          "(H = KV = 20, hd 64; 1,500 frames)")
    t0 = time.perf_counter()
    shapes = phase_wh_shapes(rng)
    for name, key in (("flash_attention", "k3"), ("flash_decode", "k4"),
                      ("flash_attention_bwd", "bwd")):
        by_name[name]["max_abs_err"] = max(by_name[name]["max_abs_err"], shapes[key])
    print(f"  [54] took {time.perf_counter() - t0:.1f} s")

    print(f"[55] serving path: {WH_ARCH} whole, bf16, {WH_BATCH} x (1,500 frames + "
          f"{WH_PROMPT} tokens), {WH_GEN} steps")
    t0 = time.perf_counter()
    served = phase_wh_serve()
    print(f"  [55] took {time.perf_counter() - t0:.1f} s")

    print(f"[56] card vs host: {WH_HOST_LAYERS} + {WH_HOST_LAYERS} layers at full width, f32")
    t0 = time.perf_counter()
    phase_wh_card_vs_host()
    print(f"  [56] took {time.perf_counter() - t0:.1f} s")

    print(f"[57] federated training: {WH_ARCH} whole, f32, remat on, {WH_TRAIN_ROUNDS} rounds")
    t0 = time.perf_counter()
    trained = phase_wh_training()
    print(f"  [57] took {time.perf_counter() - t0:.1f} s")

    print("[58] make_round_step on the Whisper smoke model with frames, fedsgd and "
          "sparse_replicated, card vs host")
    t0 = time.perf_counter()
    steps = phase_wh_steps()
    k1 = by_name["union_segsum"]
    for mode, got in steps.items():
        k1["max_abs_err"] = max(k1["max_abs_err"], got["k1_err"])
        k1.setdefault("launches_by_path", {})[f"whisper smoke make_round_step {mode}"] = \
            got["launches"]["union_segsum"]
    print(f"  [58] took {time.perf_counter() - t0:.1f} s")

    def row(kernel: str, name: str, launches: int) -> dict:
        source, replaces = {
            "flash_attention": ("flash_attention.cu", "src/repro/kernels/flash_attention.py:100"),
            "flash_decode": ("flash_decode.cu", "src/repro/kernels/flash_decode.py:88"),
            "flash_attention_bwd": ("flash_attention_bwd.cu", "src/repro/models/layers.py:154"),
        }[kernel]
        return {"name": f"{kernel} ({name})", "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}", "replaces": replaces,
                "launches": launches, **shapes["timed"][name]}

    rows = [row("flash_attention", name, served["tally"][("k3", sq, sk, causal)])
            for name, _, sq, sk, causal in WH_K3_CASES]
    rows += [row("flash_decode", name, served["tally"][("k4", slots)])
             for name, _, slots in WH_K4_CASES]
    rows += [row("flash_attention_bwd", name, trained["tally"][("bwd", sq, sk, causal)])
             for name, sq, sk, causal in WH_BWD_CASES]
    check(all(r["launches"] > 0 for r in rows), "[55]/[57]: a Whisper shape was not launched")
    return rows

# ---------------------------------------------------------------------------
# [59]-[63]: the checking planes
# ---------------------------------------------------------------------------

#: [60]: PERF.md §6's bounds, each from cost_model at its row's shape: (row,
#: kernel, shape, the bound's key, ms to the 4th decimal, what bounds it)
SECTION6_BOUNDS = (
    ("K3 at Whisper's encoder", "flash_attention",
     dict(b=4, sq=1500, h=20, kv=20, hd=64, keys=1500, pairs=1500 * 1500, dtype="bf16"),
     "bound_ms", 0.0466, "operations"),
    ("K3 at Mixtral's prefill", "flash_attention",
     dict(b=2, sq=8192, h=48, kv=8, hd=128, keys=8192, pairs=25167872, dtype="bf16"),
     "bound_ms", 1.2508, "operations"),
    ("K4 at Qwen2.5-14B's step", "flash_decode",
     dict(b=4, h=40, kv=8, hd=128, n_valid=1056, slots=1056, dtype="bf16"), "bound_ms",
     0.0052, "bytes"),
    ("K3's backward at the training shape, on its route", "flash_attention_bwd",
     dict(b=16, sq=128, h=40, kv=8, hd=128, keys=128, pairs=128 * 129 // 2, dtype="f32"),
     "route_ms", 0.0602, "bytes"),
    ("K3's backward at the training shape, on the f32 CUDA cores", "flash_attention_bwd",
     dict(b=16, sq=128, h=40, kv=8, hd=128, keys=128, pairs=128 * 129 // 2, dtype="f32"),
     "bound_ms", 0.1009, "operations"),
    ("K4's log-sum-exp instance at Qwen2.5-14B's rank slice, m = 2", "flash_decode",
     dict(b=4, h=40, kv=8, hd=128, n_valid=2064, slots=2064, dtype="bf16", lse=True),
     "bound_ms", 0.0101, "bytes"),
    ("K4's log-sum-exp instance at Qwen2.5-14B's rank slice, m = 4", "flash_decode",
     dict(b=4, h=40, kv=8, hd=128, n_valid=1032, slots=1032, dtype="bf16", lse=True),
     "bound_ms", 0.0051, "bytes"),
    ("K3 at Whisper's encoder, a (1, 2) rank's training heads", "flash_attention",
     dict(b=4, sq=1500, h=10, kv=10, hd=64, keys=1500, pairs=1500 * 1500, dtype="f32"),
     "bound_ms", 0.3439, "operations"),
    ("K3's backward at Whisper's encoder, a (1, 2) rank's heads, on its route",
     "flash_attention_bwd",
     dict(b=4, sq=1500, h=10, kv=10, hd=64, keys=1500, pairs=1500 * 1500, dtype="f32"),
     "route_ms", 0.3491, "operations"),
    ("K3 at Whisper's encoder prefill, a (1, 4) rank's heads", "flash_attention",
     dict(b=2, sq=1500, h=5, kv=5, hd=64, keys=1500, pairs=1500 * 1500, dtype="bf16"),
     "bound_ms", 0.0058, "operations"),
    ("K4's log-sum-exp instance at Whisper's cross cache, a (1, 2) rank's slice",
     "flash_decode",
     dict(b=2, h=20, kv=20, hd=64, n_valid=750, slots=750, dtype="bf16", lse=True),
     "bound_ms", 0.0023, "bytes"),
    ("K1 at the heavy shape, f32", "union_segsum",
     dict(t=512000, d=18, cap=512000, n_union=258137, dtype="f32"), "bound_ms", 0.0235,
     "bytes"),
    ("K1 at the heavy shape, bf16", "union_segsum",
     dict(t=512000, d=18, cap=512000, n_union=258137, dtype="bf16"), "bound_ms", 0.0180,
     "bytes"),
    ("K2 at the heavy shape, f32", "rowsparse_scatter",
     dict(t=512000, d=18, v=1 << 22, n_union=258137, dtype="f32"), "bound_ms", 0.1021,
     "bytes"),
)


def section6_bound(kernel: str, shape: dict, key: str) -> tuple:
    """(ms, what bounds it, bytes, flops) of one §6 row from cost_model."""
    c = cost_model(kernel, **shape)
    if key == "bound_ms":
        return c.bound_ms, c.bound_by, c.bytes, c.flops
    return c.extra[key], c.extra["route_by"], c.bytes, c.flops


def phase_kernel_audit() -> list:
    """[59]: every registry entry at its audit shapes on the card: resource,
    state and coverage contracts, each planted breaker failing its gate."""
    reports = kernel_audit.audit_all()
    coverage = kernel_audit.registry_coverage()
    kernel_audit.print_reports(reports, coverage)
    bad = [f for r in reports for f in r.failures] + coverage
    check(not bad, f"[59]: {len(bad)} contract failures: {bad[:4]}")
    tags = {"cluster": "[cluster]", "grid": "[cooperative-grid]", "spill": "[spill]",
            "coverage": "[coverage]"}
    for kind in kernel_audit.PLANTS:
        planted = kernel_audit.planted_failures(reports, kind)
        check(planted and all(tags[kind] in f for f in planted),
              f"[59]: the planted {kind} breaker drew {planted[:2]}")
        print(f"  planted {kind}: {len(planted)} failures, e.g. {planted[0][:110]}")
    return reports


def phase_cost_and_constants() -> None:
    """[60]: §6's bounds from ``cost_model``; ``HW`` against the card."""
    for label, kernel, shape, key, want, want_by in SECTION6_BOUNDS:
        got, by, nbytes, flops = section6_bound(kernel, shape, key)
        print(f"  {label}: {got:.5f} ms ({by}; {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} "
              f"GFLOP); PERF.md §6: {want} ({want_by})")
        check(round(got, 4) == want and by == want_by,
              f"[60]: {label}: {got:.5f} ms ({by}), §6 says {want} ({want_by})")
    props = torch.cuda.get_device_properties(0)
    print(f"  HW is the one object chip_smoke, kernel_audit and introspect read: "
          f"{HW is kernel_audit.HW}")
    check(HW is kernel_audit.HW, "[60]: kernel_audit reads another HW")
    rows = (("sms", "multi_processor_count"), ("regs_per_sm", "regs_per_multiprocessor"),
            ("smem_per_block", "shared_memory_per_block_optin"),
            ("smem_per_sm", "shared_memory_per_multiprocessor"), ("l2_bytes", "L2_cache_size"),
            ("threads_per_block", "max_threads_per_block"))
    for key, attr in rows:
        have = getattr(props, attr, None)
        check(have is not None, f"[60]: the card's properties do not expose {attr}")
        print(f"  HW[{key!r}] = {HW[key]}, the card's {attr} = {have}")
        check(have == HW[key], f"[60]: HW[{key!r}] is {HW[key]}, the card says {have}")
    total = props.total_memory
    print(f"  HW['hbm_bytes'] = {HW['hbm_bytes']} (the data sheet's 80 GB), the card's "
          f"total_memory = {total} (the memory CUDA reports)")
    check(0.95 * HW["hbm_bytes"] <= total <= 1.08 * HW["hbm_bytes"],
          f"[60]: the card has {total} bytes, HW says {HW['hbm_bytes']}")
    clock, width = getattr(props, "memory_clock_rate", None), getattr(props, "memory_bus_width",
                                                                       None)
    check(clock and width, "[60]: the card's properties expose no memory clock and bus")
    rate = 2 * clock * 1e3 * width / 8
    print(f"  HW['hbm_bandwidth'] = {HW['hbm_bandwidth']:.4g} B/s, the card's memory "
          f"clock and bus give {rate:.4g} B/s")
    check(abs(rate - HW["hbm_bandwidth"]) <= 0.02 * HW["hbm_bandwidth"],
          f"[60]: the card's memory moves {rate:.4g} B/s, HW says {HW['hbm_bandwidth']}")


def round_inputs(ds, k: int = 100, seed: int = SEED + 61) -> tuple:
    """The trainer's round at full width on the card: parameters, axes,
    loss, config, feature keys and one cohort batch of ``k`` clients (5
    local steps of 5 samples) with the heat as ``heat_vocab``."""
    make_params, loss_fn, _ = task_bindings(ds, SEED)
    params, axes = make_params(DEV)
    cfg = FedConfig(num_clients=ds.num_clients, clients_per_round=k, local_iters=5,
                    local_batch=5, lr=0.5, seed=SEED)
    keys = (ds.feature_key,) + (("target",) if ds.feature_key == "hist" else ())
    rng = np.random.default_rng(seed)
    ids = rng.choice(ds.num_clients, size=k, replace=False)
    batch = {key: torch.from_numpy(np.ascontiguousarray(v)).to(DEV)
             for key, v in sample_cohort_batch(ds, ids, 5, 5, rng).items()}
    batch["heat_vocab"] = torch.as_tensor(ds.heat.counts, dtype=torch.float32, device=DEV)
    return params, axes, loss_fn, cfg, keys, batch


def round_plan(mode: str, cfg, keys):
    return dataclasses.replace(resolve_plan(mode, cfg), feature_keys=keys)


def phase_memory_contract(tasks: dict) -> None:
    """[61]: each sparse round at full width against its memory budget: LR
    and DIN within the reference's six components, every round within the
    six plus each client's dense leaves and activations, priced from the
    plan's shapes (``memory_budget(clients=True)``). Two plants must trip
    that budget: the round's own peak plus one f32 copy of the tables per
    client (a client that densified its table), and the dense-replica
    round."""
    for task, ds in tasks.items():
        params, axes, loss_fn, cfg, keys, batch = round_inputs(ds)
        lean_plan = round_plan("sparse_replicated", cfg, keys)
        budget = hlo_audit.memory_budget(lean_plan, axes, params, cfg, batch, clients=True)
        lean = hlo_audit.memory_contract(lean_plan, loss_fn, axes,
                                         {n: v.clone() for n, v in params.items()}, cfg,
                                         batch, budget=budget)
        six = hlo_audit.memory_contract(lean_plan, loss_fn, axes, params, cfg, batch,
                                        measured=lean.measured_bytes)
        copies = cfg.clients_per_round * budget["tables_scratch"]
        densified = hlo_audit.memory_contract(lean_plan, loss_fn, axes, params, cfg, batch,
                                              measured=lean.measured_bytes + int(copies),
                                              budget=budget)
        fat = hlo_audit.memory_contract(round_plan("replicated", cfg, keys), loss_fn, axes,
                                        {n: v.clone() for n, v in params.items()}, cfg, batch,
                                        budget=budget)
        print(f"  {task} (V {ds.num_features}, K {cfg.clients_per_round}): sparse round peak "
              f"{lean.measured_bytes / 1e6:.2f} MB against {lean.budget_bytes / 1e6:.2f} MB "
              f"allowed ({'ok' if lean.ok else 'FAIL'}); the six reference components "
              f"allow {six.budget_bytes / 1e6:.2f} MB ({'within' if six.ok else 'over'}); "
              "budget " + ", ".join(f"{k} {v / 1e6:.2f}" for k, v in budget.items()) + " MB")
        print(f"  {task} plants against that budget: a table copy per client "
              f"{densified.measured_bytes / 1e6:.2f} MB "
              f"({'trips' if not densified.ok else 'DOES NOT TRIP'}), the dense-replica round "
              f"{fat.measured_bytes / 1e6:.2f} MB ({'trips' if not fat.ok else 'DOES NOT TRIP'})")
        check(lean.ok, f"[61] {task}: {lean.failures}")
        if task != "lstm":      # the LSTM's cells outgrow the six terms: ROADMAP Queue 3
            check(six.ok, f"[61] {task}, the reference's six terms: {six.failures}")
        for plant in (densified, fat):
            check(not plant.ok and any("peak live bytes" in f for f in plant.failures),
                  f"[61] {task}: a planted {plant.measured_bytes} B did not trip the budget")
        del params, batch
        torch.cuda.empty_cache()


def phase_dense_intermediates(tasks: dict) -> None:
    """[62]: one sparse round step under the dispatch mode, LR at
    MovieLens-1M width with [61]'s 100 clients and the LSTM with 25: no
    (V, ...) float output; their dense plans: hits, each listed. The
    detector reads shapes, so it sees a densification only while the
    round's union capacity, min(V, the cohort's ids), is below V: the
    LSTM's 100 clients read 60,000 ids of 20,000 rows, and there the union
    rows are (V, D) in both packages
    (``tests/test_torch_analysis.py::test_union_at_capacity_v_is_flagged_in_both``)."""
    for task, (ds, k) in tasks.items():
        params, axes, loss_fn, cfg, keys, batch = round_inputs(ds, k=k)
        v = ds.num_features
        cap = plan_mod.round_capacity(v, sum(batch[key].numel() for key in keys))
        print(f"  {task}, {k} clients: union capacity {cap} of V {v}")
        check(cap < v, f"[62] {task}: a union of capacity V hides a densification")
        for mode in ("sparse_replicated", "replicated"):
            step = build_round_step(round_plan(mode, cfg, keys), loss_fn, axes, params, cfg)
            state = ServerState({n: x.clone() for n, x in params.items()}, (), 0)
            hits = find_dense_intermediates(step, state, batch, dim0=v)
            print(f"  {task} {mode}: {len(hits)} dense (V = {v}, ...) float outputs")
            for h in hits:
                print(f"    {h}")
            if mode == "sparse_replicated":
                check(not hits, f"[62] {task}: the sparse round built {len(hits)} dense "
                      "intermediates")
            else:
                check(hits, f"[62] {task}: the dense round shows no dense intermediate")
        del params, batch
        torch.cuda.empty_cache()


def phase_comm_drift(mesh_drift: dict) -> None:
    """[63]: [33]'s counted combine bytes, every rank and step, against
    ``sharded_combine_bytes`` within 10% plus 64 B."""
    check(mesh_drift, "[63]: [33] recorded no drift")
    for label, per_rank in mesh_drift.items():
        for r, steps in enumerate(per_rank):
            for d in steps:
                check(d["ok"], f"[63] {label} rank {r}: {d['failures']}")
        d = per_rank[0][-1]
        print(f"  {label}: counted {d['measured_by_op']} against predicted "
              f"{d['predicted_by_op']} on {len(per_rank)} ranks x {len(per_rank[0])} steps")


def phase_checking_planes(kernels: list, lr_ds, din_ds, lstm_ds, mesh_drift: dict) -> None:
    """[59]-[63], each timed."""
    for n, title, fn in (
            (59, "kernel audit: resources, state and coverage of every registry entry",
             phase_kernel_audit),
            (60, "cost model and constants", phase_cost_and_constants),
            (61, "memory contract: LR, DIN and the LSTM sparse rounds at full width",
             lambda: phase_memory_contract({"lr": lr_ds, "din": din_ds, "lstm": lstm_ds})),
            (62, "dense intermediates of the LR and LSTM rounds at full width",
             lambda: phase_dense_intermediates({"lr": (lr_ds, 100), "lstm": (lstm_ds, 25)})),
            (63, "comm drift of [33]'s sharded steps", lambda: phase_comm_drift(mesh_drift))):
        print(f"[{n}] {title}")
        t0 = time.perf_counter()
        fn()
        print(f"  [{n}] took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# [64]-[66]: the sharded LLM step on a (data, model) mesh
# ---------------------------------------------------------------------------

#: [64]-[65]'s corpus, cohort and rounds: a cohort of 8 sequences of 128
#: tokens, so that a rank of a (1, m) mesh runs K3 at B 8, S 128
TP_RUN = dict(clients=64, cohort=8, seq=128, zipf_a=1.3, lr=LM_LR, algorithm="fedsubavg")
TP_ROUNDS = 2
#: [64]: Qwen2.5-14B at its widths on these meshes of gloo ranks sharing the
#: card, each at this depth for this many rounds (one single-device run per
#: depth and rounds); the 1-layer meshes take one round, which pays for [70]
TP_QWEN_MESHES = (((1, 2), 2, 2), ((2, 2), 1, 1), ((1, 4), 1, 1))
TP_QWEN_REDUCED = ("layers 48 -> 2 on (1, 2) and 1 on (2, 2) and (1, 4): 2 layers are "
                   "2.11 B f32 parameters (8.43 GB, 6.23 GB of them the embedding and "
                   "lm_head), each rank draws them whole before it keeps its part, and "
                   "2 or 4 ranks share the one card; rounds 2 on (1, 2), 1 on (2, 2) "
                   "and (1, 4)")
#: [65]: Mixtral at its widths, 1 layer, both MoE layouts on (1, 2)
TP_MOE_LAYERS = 1
TP_MOE_REDUCED = ("layers 56 -> 1: 2.91 B f32 parameters (11.6 GB), drawn whole by each "
                  "of 2 ranks sharing the card")
TP_TIMEOUT_S = 600.0
#: [66]: the 1-rank NCCL mesh's model (the launcher's 100m scale)
TP_NCCL_SCALE = "100m"
#: the per-rank shapes of [64]'s K3 rows: (1, 2) and (1, 4) at B 8, S 128
TP_K3_CASES = (("m = 2", (8, 128, 20, 4, 128), (1, 2)), ("m = 4", (8, 128, 10, 2, 128), (1, 4)))
#: [70]: Qwen2.5-14B at its widths on the row-sparse transport (fedsubavg,
#: ``TP_RUN``'s corpus, ``TP_ROUNDS`` rounds) on these meshes, its jobs in
#: [64]'s spawn; the (2, 2) job's K1 is held and timed
SP_MESHES = ((1, 2), (2, 2))
SP_LAYERS = 1
SP_REDUCED = ("layers 48 -> 1: one layer is 1.83 B f32 parameters (7.3 GB), drawn whole by "
              "each rank before it keeps its part, and 2 or 4 ranks share the one card")
SP_K1_MESH = (2, 2)
#: [74]: the dry run's other layouts, jobs that ride [64]'s spawn, each held
#: to a single-device run [64] or [70] already makes: (label, mesh shape,
#: layout, reference: "qwen" [64]'s 1-layer run, "sparse" [70]'s). Mixtral
#: at 1 layer under FSDP on (2, 2) does not fit: 4 ranks on the one card,
#: each gathering its half of the experts whole (1.5 GiB a weight) and its
#: gradient, ran out of its 80 GB; it is held on the host alone
#: (tests/test_torch_fsdp.py)
LY_TRAIN = (("fsdp (2, 2)", (2, 2), "fsdp", "qwen"),
            ("tp (2, 1, 2)", (2, 1, 2), "tp", "qwen"),
            ("fsdp sparse (2, 2)", (2, 2), "fsdp", "sparse"))
#: [74] (c): served under FSDP on (2, 2) in [67]'s spawn, at the depth, batch
#: and prompt of SV_F32_JOBS' "qwen (1, 4)", held to the one-device run [68]
#: holds that job to, for its first 2 greedy steps: every step gathers each
#: rank's weights over 'data' through gloo's host copies, 3-5 s a step on an
#: H100 where [68]'s take 0.1 s
LY_SERVE = ("qwen fsdp (2, 2)", (2, 2), "fsdp", "qwen (1, 4)", 2)


@contextlib.contextmanager
def record_routes(out: list):
    """Wrap ``layers.moe_route``: each call appends its expert ids and kept
    assignments (the caller's tokens')."""
    inner = layers_mod.moe_route

    def route(*a, **kw):
        r = inner(*a, **kw)
        out.append((r.expert_ids.tolist(), r.keep.tolist()))
        return r

    layers_mod.moe_route = route
    try:
        yield out
    finally:
        layers_mod.moe_route = inner


def tp_reference_run(cfg, rounds: int, sparse: bool, run: dict, device,
                     keep_first: bool = False) -> dict:
    """``train`` on one device from the seed's weights, ``rounds`` rounds of
    ``run`` (on the row-sparse transport with ``sparse``): its final
    parameters (``"params"``, on ``device``) and with ``keep_first`` those
    after the first round (``"first"``), each leaf's update norm, its
    losses, K3's counts, the MoE's routing, and on the sparse transport
    each round's ``sub_rows`` and uplink bytes."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    p0, axes = lm_params(cfg, device)
    lm_zero_counts()
    subs: list = []
    add_sub = sub_rows_into(subs)
    first: dict = {}

    def on_round(r, params, metrics):
        add_sub(r, params, metrics)
        if keep_first and r == 0:
            first.update({n: t.clone() for n, t in params.items()})

    with record_routes([]) as routes:
        res = train_mod.train(cfg, rounds=rounds, device=device, params=dict(p0), axes=axes,
                              log_every=0, sparse=sparse, on_round=on_round, **run)
    launches = lm_counts()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    update = {n: float((res.params[n] - p0[n]).float().norm()) for n in p0}
    del p0
    check(all(math.isfinite(x) for x in res.losses), f"{cfg.name}: a loss is not finite")
    return {"params": res.params, "first": first or None, "losses": res.losses,
            "ms": res.ms_per_round, "update": update, "launches": launches, "routes": routes,
            "peak_gb": peak / 1e9, "sparse": sparse, "sub_rows": subs,
            "bytes_up": res.bytes_up_sparse}


def tp_reference(cfg, label: str, rounds: int = TP_ROUNDS, sparse: bool = False) -> dict:
    """The single-device run a mesh is held to (``tp_reference_run`` on the
    card, ``TP_RUN``'s rounds). Its final parameters go to a file under
    ``build/`` that the ranks map; the rest stays here."""
    t0 = time.perf_counter()
    out = tp_reference_run(cfg, rounds, sparse, TP_RUN, DEV)
    params = out.pop("params")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"tp_reference_{label}.pt"
    torch.save({n: t.cpu() for n, t in params.items()}, path)
    del params
    print(f"  one device, {cfg.name} {cfg.num_layers} layer(s): loss "
          f"{[round(x, 6) for x in out['losses']]}, ms/round "
          f"{[round(x, 1) for x in out['ms']]}, peak {out['peak_gb']:.2f} GB, launches "
          f"{out['launches']} ({card_line()})")
    torch.cuda.empty_cache()
    out.update(path=str(path), s=time.perf_counter() - t0)
    return out


def sub_rows_into(out: list):
    """An ``on_round`` that appends each round's ``sub_rows`` (sparse rounds)."""
    def on_round(r, params, metrics):
        if "sub_rows" in metrics:
            out.append(int(metrics["sub_rows"]))

    return on_round


def tp_job(mesh, job: dict) -> dict:
    """One run of ``train(mesh=...)`` on a rank: losses, ms, peak, K3's
    and K1's counts, each round's counters and ``tp_collective_budget``,
    whether every leaf the rules leave whole has the same bits on every
    model rank after each round, the routing, and each leaf's part against
    the single-device run's (``job["ref"]``, mapped from its file). A
    ``sparse`` job runs the row-sparse transport and adds each round's
    ``sub_rows`` and uplink bytes; with ``capture`` the mesh's first rank
    keeps the inputs of its last K1 call. An ``inline`` job makes its
    single-device run here, on the rank's device before the mesh's (nothing
    written to disk), and returns its numbers as ``"ref"``; the rank's
    parameters after the first round are then held to its (``err1``) and
    the second round starts from their part: the chaotic families' rounds
    are each held from a common start."""
    t0 = time.perf_counter()
    cfg, sparse, rounds = job["cfg"], job.get("sparse", False), job.get("rounds", TP_ROUNDS)
    run = job.get("run", TP_RUN)
    layout = job.get("layout", "tp")
    inline = (tp_reference_run(cfg, rounds, sparse, run, mesh.device, keep_first=True)
              if job.get("inline") else None)
    rules = train_mod.mesh_rules(cfg, mesh, job["ep"], layout)
    meta = build_model(cfg).abstract_params()
    full = {n: tuple(t.shape) for n, t in meta.state_dict().items()}
    specs = param_specs(meta.axes, full, mesh, rules)
    whole = [n for n, spec in specs.items() if not any(spec)]
    model = mesh.axis("model")
    same: list = []

    subs: list = []
    add_sub = sub_rows_into(subs)

    err1: dict = {}

    def on_round(r, local, metrics):
        add_sub(r, local, metrics)
        if model.size > 1:
            same.append(all(bool((g == g[0]).all()) for g in (
                model.all_gather(local[n], "check") for n in whole)))
        if inline is not None and r == 0:
            for n, t in local.items():
                want = local_part(inline["first"][n], mesh, specs[n])
                err1[n] = float((t - want).abs().max())
                t.copy_(want)

    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    lm_zero_counts()
    captured: dict = {}
    with record_routes([]) as routes, capture_k1(captured):
        res = train_mod.train(cfg, rounds=rounds, device=mesh.device, mesh=mesh,
                              expert_parallel=job["ep"], log_every=0, on_round=on_round,
                              sparse=sparse, layout=layout, **run)
    launches = lm_counts()
    # from the rank keeping its part (the whole draw freed) to the end
    peak = res.peak_bytes
    resident = sum(t.numel() * t.element_size() for t in res.params.values())
    budget = plan_mod.tp_collective_budget(
        cfg, mesh, {"tokens": torch.zeros(run["cohort"], run["seq"])}, rules=res.rules,
        sparse=sparse)
    ref = (inline.pop("params") if inline is not None
           else torch.load(job["ref"], mmap=True, weights_only=True))
    err, sq = {}, {}
    for n, got in res.params.items():
        want = local_part(ref[n], mesh, specs[n]).to(mesh.device)
        diff = (got - want).double()
        err[n], sq[n] = float(diff.abs().max()), float((diff * diff).sum())
        del want, diff
    out = {"losses": res.losses, "ms": res.ms_per_round, "peak_gb": peak / 1e9,
           "launches": launches, "counters": res.counters, "budget": budget["axes"],
           "same": same, "routes": routes, "err": err, "sq": sq, "coords": mesh.coords,
           "data": math.prod(mesh.shape[n] for n in rules["batch"]),
           "axis_names": mesh.axis_names, "specs": specs, "resident_gb": resident / 1e9,
           "split": sorted(n for n in specs if n not in whole),
           "sub_rows": subs, "bytes_up": res.bytes_up_sparse, "rounds": rounds,
           "err1": err1}
    if inline is not None:
        out["ref"] = {k: v for k, v in inline.items() if k != "first"}
    if job.get("capture") and mesh.rank == mesh.ranks[0] and "args" in captured:
        out["k1_args"] = tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                               for a in captured["args"])
        out["k1_kw"] = captured["kw"]
    del ref, res, captured
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def tp_rank(rank: int, world: int, store: str, out_dir: str, jobs: list, device: str) -> None:
    """One gloo rank sharing the card: each job on its own mesh laid over
    the world; its results saved for the parent. A job with ``blocks`` runs
    its i-th entry on the world's i-th mesh (None: that mesh's ranks wait);
    a job of ``kind`` "serve" is ``serve_job``'s, else ``tp_job``'s."""
    import torch.distributed as dist

    global DEV
    DEV = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        results = {}
        for job in jobs:
            mesh = make_device_mesh(job["shape"], MESH_AXES[len(job["shape"])], device=DEV)
            if "blocks" in job:
                job = job["blocks"][mesh.ranks[0] // len(mesh.ranks)]
                if job is None:
                    continue
            run = serve_job if job.get("kind") == "serve" else tp_job
            results[job["label"]] = run(mesh, job)
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_tp(world: int, jobs: list) -> list:
    """Spawn ``world`` gloo ranks of ``tp_rank`` on the card; their results."""
    out_dir = Path(tempfile.mkdtemp(prefix=f"tp{world}_", dir=ROOT / "build"))
    t0 = time.perf_counter()
    try:
        spawn_ranks(tp_rank, world, args=(world, str(out_dir / "store"), str(out_dir), jobs,
                                          str(DEV)), timeout_s=TP_TIMEOUT_S)
        res = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"  {world} gloo ranks on the card: spawned, ran and joined in "
          f"{time.perf_counter() - t0:.1f} s")
    return res


def check_tp(label: str, ranks: list, ref: dict) -> dict:
    """[64]/[65]'s checks of one job on every rank: losses and every leaf
    within ``LM_HOST_TOL`` of the single-device run, each leaf's update
    within ``LM_UPDATE_TOL`` in relative norm (the squared differences of
    one data row's model ranks summed; the mLSTM's ``b_i`` is held by its
    parameters alone), K3 and its backward as often per
    rank as on one device, whole leaves the same bits on every model rank,
    and the routing the single device's."""
    first = ranks[0][label]
    for r, per in enumerate(ranks):
        got = per[label]
        check(np.allclose(got["losses"], ref["losses"], rtol=LM_HOST_TOL, atol=LM_HOST_TOL),
              f"{label} rank {r}: losses {got['losses']} against one device's {ref['losses']}")
        worst = max(got["err"].values())
        check(worst <= LM_HOST_TOL, f"{label} rank {r}: a parameter is {worst:.3g} from one "
              "device's")
        if got.get("err1"):
            worst1 = max(got["err1"].values())
            check(worst1 <= LM_HOST_TOL, f"{label} rank {r}: after the first round a "
                  f"parameter is {worst1:.3g} from one device's")
        want = dict(ref["launches"])
        if ref["sparse"]:
            # one device's flat round calls no K1; the union combine calls it
            # once a round on every rank, on the rank's slice
            check(want["union_segsum"] == 0, f"{label}: one device launched K1")
            want["union_segsum"] = len(ref["losses"])
            check(got["sub_rows"] == ref["sub_rows"],
                  f"{label} rank {r}: sub_rows {got['sub_rows']}, one device {ref['sub_rows']}")
            check(got["bytes_up"] == ref["bytes_up"], f"{label} rank {r}: uplink bytes "
                  f"{got['bytes_up']}, one device {ref['bytes_up']}")
        check(got["launches"] == want,
              f"{label} rank {r}: launches {got['launches']}, want {want}")
        check(all(got["same"]), f"{label} rank {r}: a whole leaf differs across model ranks")
        if got["data"] == 1:
            check(got["routes"] == ref["routes"], f"{label} rank {r}: routing differs")
    rel = {}
    for n, norm in ref["update"].items():
        # the mLSTM's input-gate bias has an exact gradient of 0 (as in
        # smoke_steps_card_vs_host): its update is rounding noise on either
        # side, held by the parameters
        if n.endswith(".b_i"):
            continue
        # one copy of each part: the ranks at 0 on every axis that does not
        # split the leaf
        used = {a for p in first["specs"][n] if p for a in ((p,) if isinstance(p, str) else p)}
        sq = sum(per[label]["sq"][n] for per in ranks
                 if all(c == 0 for a, c in zip(first["axis_names"], per[label]["coords"])
                        if a not in used))
        rel[n] = math.sqrt(sq) / norm if norm > 0 else math.sqrt(sq)
    worst = max(rel, key=rel.get)
    check(rel[worst] <= LM_UPDATE_TOL, f"{label}: the update of {worst} is {rel[worst]:.3g} "
          "from one device's in relative norm")
    ms = [statistics.median(per[label]["ms"][1:] or per[label]["ms"]) for per in ranks]
    print(f"  {label}: loss {[round(x, 6) for x in first['losses']]} (one device "
          f"{[round(x, 6) for x in ref['losses']]}); max |param diff| "
          f"{max(max(p[label]['err'].values()) for p in ranks):.3g}; worst update "
          f"{rel[worst]:.3g} ({worst}); ms/round {[round(x, 1) for x in ms]} by rank (one "
          f"device {statistics.median(ref['ms'][1:] or ref['ms']):.1f}); peak "
          f"{[round(p[label]['peak_gb'], 2) for p in ranks]} GB by rank; launches per rank "
          f"{first['launches']}; {card_line()}")
    return {"launches": first["launches"], "ms": ms}


def tp_nccl(cfg) -> None:
    """[66] (b): a 1-rank NCCL ``(1, 1)`` mesh in this process, its rounds
    within ``LM_STEP_TOL`` of the single-device rounds (the mesh changes no
    arithmetic, but two runs of one device already differ in the embedding
    gradient's unordered adds), its counters the budget's."""
    single = train_mod.train(cfg, rounds=TP_ROUNDS, device=DEV, log_every=0, **TP_RUN)
    store = Path(tempfile.mkdtemp(prefix="nccl_", dir=ROOT / "build"))
    mesh = make_device_mesh((1, 1), device=DEV, backend="nccl", init_method=f"file://{store / 's'}",
                     rank=0, world_size=1)
    try:
        res = train_mod.train(cfg, rounds=TP_ROUNDS, device=DEV, log_every=0, mesh=mesh,
                              **TP_RUN)
        budget = plan_mod.tp_collective_budget(
            cfg, mesh, {"tokens": torch.zeros(TP_RUN["cohort"], TP_RUN["seq"])},
            rules=res.rules)["axes"]
    finally:
        mesh.destroy()
        shutil.rmtree(store, ignore_errors=True)
    err = max(float((res.params[n] - single.params[n]).abs().max()) for n in single.params)
    check(np.allclose(res.losses, single.losses, rtol=LM_STEP_TOL, atol=LM_STEP_TOL),
          f"NCCL (1, 1): losses {res.losses} against one device's {single.losses}")
    check(err <= LM_STEP_TOL, f"NCCL (1, 1): a parameter is {err:.3g} from one device's")
    check(all(c == budget for c in res.counters),
          f"NCCL (1, 1): counters {res.counters[-1]} against {budget}")
    print(f"  NCCL (1, 1), {cfg.name} at the {TP_NCCL_SCALE} scale: loss "
          f"{[round(x, 6) for x in res.losses]}, one device's {[round(x, 6) for x in single.losses]}"
          f", max |param diff| {err:.3g}; counters "
          f"{res.counters[-1]} equal the budget; {card_line()}")


def phase_tp_slice(kernels: list, rng, extra: list = ()) -> tuple:
    """[64]-[66], each timed; adds the errors of K3 and its backward at the
    ranks' shapes to their entries and returns their rows: K3 and its
    backward at [64]'s per-rank shapes, each with its launches per rank.
    [70]'s single-device run is made here and its jobs ride [64]'s spawn;
    their results are returned for [70]. ``extra`` spawn entries ([71]'s
    jobs) ride it too; the world's results are returned for them."""
    by_name = {e["name"]: e for e in kernels}
    print(f"[64] {LM_ARCH} at its widths, f32, fedsubavg, rounds of "
          f"{TP_RUN}: one device, then (data, model) meshes of gloo ranks sharing the card; "
          f"[65]'s and [70]'s runs ride the same spawn of 4 ranks")
    t0 = time.perf_counter()
    print(f"  reduced: {TP_QWEN_REDUCED}")
    refs, jobs, want = {}, {}, {}

    def add(label: str, shape: tuple, cfg, ep: bool, ref: dict, **kw) -> None:
        jobs[label] = {"label": label, "shape": shape, "cfg": cfg, "ep": ep,
                       "ref": ref["path"], "rounds": len(ref["losses"]), **kw}
        want[label] = ref

    for shape, layers, rounds in TP_QWEN_MESHES:
        if (layers, rounds) not in refs:
            refs[layers, rounds] = tp_reference(lm_config(layers), f"qwen{layers}x{rounds}",
                                                rounds)
        add(f"{LM_ARCH} {shape}", shape, lm_config(layers), False, refs[layers, rounds])
    print(f"  [65]'s single-device run, {MOE_ARCH} at {TP_MOE_LAYERS} layer; reduced: "
          f"{TP_MOE_REDUCED}")
    moe_cfg = moe_serve_config(TP_MOE_LAYERS, dtype="float32")
    refs["moe"] = tp_reference(moe_cfg, "mixtral")
    check(refs["moe"]["routes"], "[65]: the single-device run recorded no routing")
    moe_labels = [f"{MOE_ARCH} {name} (1, 2)" for name in ("tp", "ep")]
    for label, ep in zip(moe_labels, (False, True)):
        add(label, (1, 2), moe_cfg, ep, refs["moe"])
    print(f"  [70]'s single-device run, {LM_ARCH} at {SP_LAYERS} layer on the row-sparse "
          "transport")
    refs["sparse"] = tp_reference(lm_config(SP_LAYERS), "qwen_sparse", sparse=True)
    sp_labels = [f"{LM_ARCH} sparse {shape}" for shape in SP_MESHES]
    for label, shape in zip(sp_labels, SP_MESHES):
        add(label, shape, lm_config(SP_LAYERS), False, refs["sparse"], sparse=True,
            capture=shape == SP_K1_MESH)
    ly_refs = {"qwen": (refs[1, 1], lm_config(1), False),
               "sparse": (refs["sparse"], lm_config(SP_LAYERS), True)}
    ly_labels = []
    for name, shape, layout, key in LY_TRAIN:
        ref, cfg, sp = ly_refs[key]
        label = f"{LM_ARCH} {name}"
        add(label, shape, cfg, False, ref, sparse=sp, layout=layout)
        ly_labels.append(label)
    # one spawn of 4: a (1, 2) job runs on one of the world's two (1, 2)
    # meshes, two at a time where their peaks fit on the card together
    # (Qwen2.5's two do, ~55 GB; Mixtral's two would take ~80)
    q12, s12 = f"{LM_ARCH} (1, 2)", f"{LM_ARCH} sparse (1, 2)"
    spawn = [jobs[label] for label in jobs
             if math.prod(jobs[label]["shape"]) == 4 and label not in ly_labels]
    spawn += [{"shape": (1, 2), "blocks": [jobs[q12], jobs[s12]]}]
    spawn += [{"shape": (1, 2), "blocks": [jobs[label], None]} for label in moe_labels]
    spawn += list(extra)
    spawn += [jobs[label] for label in ly_labels]
    try:
        world = run_tp(4, spawn)
    finally:
        for ref in refs.values():
            Path(ref["path"]).unlink(missing_ok=True)
    ranks = {label: [per for per in world if label in per] for label in jobs}
    tp = {}

    def held(label: str) -> None:
        tp[label] = dict(check_tp(label, ranks[label], want[label]), ranks=ranks[label])

    for label in want:
        if label not in moe_labels + sp_labels + ly_labels:
            held(label)
    sp_s = refs["sparse"]["s"] + sum(max(per[label]["s"] for per in ranks[label])
                                     for label in sp_labels)
    ly_s = sum(max(per[label]["s"] for per in ranks[label]) for label in ly_labels)
    print(f"  [64] took {time.perf_counter() - t0:.1f} s (with [65]'s runs, [70]'s "
          f"{sp_s:.1f} s and [74]'s jobs' {ly_s:.1f} s)")

    print(f"[65] {MOE_ARCH} at its widths, {TP_MOE_LAYERS} layer, f32: the tensor-parallel "
          "baseline and expert parallelism on (1, 2) against one device (run in [64]'s "
          "spawn, on one of its (1, 2) meshes)")
    for label in moe_labels:
        held(label)

    print("[66] each rank's collectives against tp_collective_budget; a 1-rank NCCL (1, 1) "
          "mesh; K3 and its backward at the ranks' shapes")
    t0 = time.perf_counter()
    for label, got in tp.items():
        check_budget(label, got["ranks"])
    tp_nccl(get_config(LM_ARCH).replace(**serve_mod.SCALES[TP_NCCL_SCALE]))
    rows = []
    for name, shape, mesh_shape in TP_K3_CASES:
        fwd, bwd = train_attention_timing(shape, SEED + 64, f"rank of {mesh_shape}")
        per_rank = tp[f"{LM_ARCH} {mesh_shape}"]["launches"]
        rounds = tp[f"{LM_ARCH} {mesh_shape}"]["ranks"][0][f"{LM_ARCH} {mesh_shape}"]["rounds"]
        for kernel, timed, source in (
                ("flash_attention", fwd, ("flash_attention.cu",
                                          "src/repro/kernels/flash_attention.py:100")),
                ("flash_attention_bwd", bwd, ("flash_attention_bwd.cu",
                                              "src/repro/models/layers.py:154"))):
            by_name[kernel]["max_abs_err"] = max(by_name[kernel]["max_abs_err"],
                                                 timed["max_abs_err"])
            rows.append({"name": f"{kernel} (Qwen2.5-14B training, rank of {mesh_shape}, "
                                 f"{name})", "route": "cuda",
                         "source": f"src/repro_torch/kernels/csrc/{source[0]}",
                         "replaces": source[1], "launches": per_rank[kernel],
                         "launches_per_round": per_rank[kernel] // rounds, **timed})
    check(all(r["launches"] > 0 for r in rows), "[64]: a rank's shape was not launched")
    print(f"  [66] took {time.perf_counter() - t0:.1f} s")
    sparse = {"ref": refs["sparse"], "s": sp_s,
              "jobs": {label: ranks[label] for label in sp_labels}}
    layouts = {"jobs": {label: ranks[label] for label in ly_labels}, "s": ly_s,
               "refs": {label: want[label] for label in ly_labels},
               "tp": {label: tp[label] for label in tp}}
    return rows, sparse, world, layouts


def check_budget(label: str, ranks: list) -> None:
    """[66]/[70]: every rank's counters of every round equal the budget."""
    for r, per in enumerate(ranks):
        run = per[label]
        check(all(c == run["budget"] for c in run["counters"]),
              f"{label} rank {r}: counters {run['counters'][-1]} against the budget "
              f"{run['budget']}")
    b = ranks[0][label]["budget"]
    print(f"  {label}: every rank's counters equal the budget each round; per rank per "
          f"round {sum(c['bytes'] for c in b['model'].values()) / 1e6:.2f} MB over "
          f"'model' in {len(b['model'])} tags, "
          f"{sum(c['bytes'] for c in b['data'].values()) / 1e6:.2f} MB over 'data'")


# ---------------------------------------------------------------------------
# [67]-[69]: sharded serving on a (data, model) mesh
# ---------------------------------------------------------------------------

#: [67]: K4's log-sum-exp form at the ranks' slices: (name, B, H, KV, hd,
#: slots of the whole cache, positions written, ring, window, slices)
SV_K4_CASES = (("Qwen2.5-14B, m = 2", 4, 40, 8, 128, 4128, 4097, False, 0, 2),
               ("Qwen2.5-14B, m = 4", 4, 40, 8, 128, 4128, 4097, False, 0, 4),
               ("Mixtral ring", 2, 48, 8, 128, 4096, 4161, True, 4096, 2),
               ("an empty slice", 4, 40, 8, 128, 4128, 1000, False, 0, 4),
               ("no valid slot", 2, 40, 8, 128, 2064, 0, False, 0, 2))
#: [67]: K3 at the ranks' prefill shapes (B, S, H, KV, hd), causal, with the
#: window, under the label of the [68]/[69] job whose ranks launch it there
SV_K3_CASES = (("bf16 (1, 2)", (4, 4096, 20, 4, 128), torch.bfloat16, 0),
               ("bf16 (1, 4)", (4, 4096, 10, 2, 128), torch.bfloat16, 0),
               ("qwen (1, 2)", (2, 1024, 20, 4, 128), torch.float32, 0),
               ("qwen (1, 4)", (4, 1024, 10, 2, 128), torch.float32, 0),
               ("mixtral tp (1, 2)", (2, 4160, 24, 4, 128), torch.float32, 4096))
#: [68]: served in f32 at these widths on gloo ranks sharing the card against
#: one device: (label, arch, layers, mesh, expert_parallel, batch, prompt)
SV_GEN = 16
SV_HOST_TOL = 1e-4
SV_F32_JOBS = (("qwen (1, 2)", LM_ARCH, 2, (1, 2), False, 2, 1024),
               ("mixtral tp (1, 2)", MOE_ARCH, 1, (1, 2), False, 2, 4160),
               ("mixtral ep (1, 2)", MOE_ARCH, 1, (1, 2), True, 2, 4160),
               ("qwen (1, 4)", LM_ARCH, 2, (1, 4), False, 4, 1024))
SV_F32_REDUCED = ("Qwen2.5-14B layers 48 -> 2 (8.43 GB f32, drawn whole by each rank before "
                  "it keeps its part), Mixtral 56 -> 1 (11.6 GB f32); 2 or 4 ranks share "
                  "the one card")
#: [69]: bf16 timing at Qwen2.5-14B's widths. Two bf16 runs that round in
#: another order part by ~1.5% in relative norm at 8 layers (measured on the
#: host at d_model 512 and 1,024: a rank's row-parallel partial is rounded
#: before the sum), as far as each is from the f32 run of the same weights
#: (~1.6%): the ranks' logits are held to the f32 run, no further from it
#: than SV_BF16_SLACK times one bf16 device's distance
SV_BF16_LAYERS, SV_BF16_BATCH, SV_BF16_PROMPT, SV_BF16_GEN = 8, 4, 4096, 32
SV_BF16_SLACK = 1.25
SV_BF16_MESHES = ((1, 2), (1, 4))
SV_BF16_REDUCED = ("layers 48 -> 8: 8 layers are 7.6 GB bf16 with the embedding and lm_head, "
                   "each rank draws them whole before it keeps its part, and 2 or 4 ranks "
                   "share the card's 80 GB")


def sv_config(arch: str, layers: int, dtype: str = "float32"):
    return get_config(arch).replace(num_layers=layers, dtype=dtype)


def sv_reference(label: str, cfg, batch: int, prompt: int, gen: int) -> dict:
    """One device's serving of a [68]/[69] job on the card, its logits and
    tokens saved under ``build/`` for the ranks; its times stay here."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build_model(cfg).init(torch.Generator(device=DEV).manual_seed(SEED), DEV)
    serve_mod.serve(cfg, batch=batch, prompt=prompt, gen=2, device=DEV, seed=SEED,
                    params=params)                                  # warm-up
    torch.cuda.reset_peak_memory_stats()
    res = serve_mod.serve(cfg, batch=batch, prompt=prompt, gen=gen, device=DEV, seed=SEED,
                          params=params)
    peak = torch.cuda.max_memory_allocated()
    del params
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"sv_reference_{re.sub(r'[^a-z0-9]+', '_', label)}.pt"
    torch.save({"logits": [lg.cpu() for lg in res.logits], "tokens": res.tokens.cpu()}, path)
    check(all(bool(torch.isfinite(lg).all()) for lg in res.logits),
          f"{label}: one device's logits are not finite")
    out = {"path": str(path), "prefill_ms": res.prefill_ms,
           "step_ms": res.decode_ms_per_token, "peak_gb": peak / 1e9,
           "cache_bytes": res.cache_bytes, "launches_prefill": res.launches_prefill,
           "launches_decode": res.launches_decode}
    del res
    torch.cuda.empty_cache()
    return out


def serve_job(mesh, job: dict) -> dict:
    """One ``serve(mesh=...)`` run on a rank: its rows of the logits against
    one device's (``job["ref"]``), the greedy tokens, the counters of the
    prefill and of each step and ``serve_collective_budget``, times, peak
    memory while serving (``ServeResult.peak_bytes``: the rank's part of the
    weights, its cache and the activations, not the whole model's draw), the
    cache's bytes and K3's and K4's launches. With ``swap`` (a leaf and
    its split dim), the rank also serves one step from a broken split and
    returns its prefill logits' distance from one device's."""
    t0 = time.perf_counter()
    cfg = job["cfg"]
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    kw = dict(batch=job["batch"], prompt=job["prompt"], gen=job["gen"], seed=SEED,
              mesh=mesh, expert_parallel=job["ep"], layout=job.get("layout", "tp"))
    if job.get("warm"):
        # cuBLAS's handles and the kernels' first loads, at a short prompt
        serve_mod.serve(cfg, **dict(kw, prompt=min(job["prompt"], 256), gen=2))
    flash_attention.launches = flash_decode.launches = flash_decode.lse_launches = 0
    res = serve_mod.serve(cfg, **kw)
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches,
                "flash_decode_lse": flash_decode.lse_launches}
    budget = plan_mod.serve_collective_budget(cfg, mesh, job["batch"], job["prompt"],
                                              job["gen"], rules=res.rules)
    ref = torch.load(job["ref"], weights_only=True)
    b = res.tokens.shape[0]
    d = _index(mesh, res.rules["batch"])                  # the rank's block of the batch
    rows = slice(d * b, (d + 1) * b) if b < job["batch"] else slice(None)
    err = [float((got.cpu() - want[rows]).abs().max())
           for got, want in zip(res.logits, ref["logits"])]
    # the largest |got - want| - SV_HOST_TOL |want| of each step: allclose's
    # rtol and atol of SV_HOST_TOL hold where it is at most SV_HOST_TOL
    excess = [float(((got.cpu() - want[rows]).abs() - SV_HOST_TOL * want[rows].abs()).max())
              for got, want in zip(res.logits, ref["logits"])]
    scale = max(float(want[rows].abs().max()) for want in ref["logits"])
    rel_f32 = None
    if job.get("ref_f32"):
        f32 = torch.load(job["ref_f32"], weights_only=True)
        rel_f32 = first_steps_rel([lg.cpu() for lg in res.logits[:2]], res.tokens.cpu(),
                                  [lg[rows] for lg in f32["logits"]], f32["tokens"][rows])
    rel_one = first_steps_rel([lg.cpu() for lg in res.logits[:2]], res.tokens.cpu(),
                              [lg[rows] for lg in ref["logits"][:2]], ref["tokens"][rows])
    out = {"err": err, "excess": excess, "scale": scale, "rel_one": rel_one,
           "rel_f32": rel_f32, "tokens": res.tokens.cpu(),
           "want_tokens": ref["tokens"][rows][:, :job["gen"]],
           "prefill_ms": res.prefill_ms, "step_ms": res.decode_ms_per_token,
           "peak_gb": res.peak_bytes / 1e9, "cache_bytes": res.cache_bytes,
           "launches": launches,
           "launches_prefill": res.launches_prefill, "launches_decode": res.launches_decode,
           "counters_prefill": res.counters_prefill, "counters_steps": res.counters_steps,
           "budget": budget, "finite": all(bool(torch.isfinite(lg).all()) for lg in res.logits),
           "coords": mesh.coords, "resident_gb": res.params_bytes / 1e9}
    del res
    if job.get("swap"):
        # a broken split for the bound to catch: one leaf's blocks over
        # ``model`` reversed, so each rank computes with another's block;
        # its prefill's logits against one device's
        name, dim = job["swap"]
        api = build_model(cfg)
        flat, axes = serve_mod.train_params(
            api.init(torch.Generator(device=mesh.device).manual_seed(SEED), mesh.device))
        flat[name] = torch.cat(flat[name].chunk(mesh.shape["model"], dim)[::-1], dim)
        bad = serve_mod.serve(cfg, **dict(kw, gen=1, params=(flat, axes)))
        del flat
        got, want = bad.logits[0].cpu(), ref["logits"][0][rows]
        out["swapped"] = {"err": float((got - want).abs().max()),
                          "excess": float(((got - want).abs() - SV_HOST_TOL * want.abs()).max())}
        del bad
    del ref
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    out["s"] = time.perf_counter() - t0
    return out


def rel_norm(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).float())
                 / torch.linalg.vector_norm(want.float()).clamp(min=1e-30))


def first_steps_rel(logits: list, tokens, want_logits: list, want_tokens) -> list:
    """Relative-norm distance of the prefill's logits, and of the first
    step's on the rows whose first greedy token agrees (None if none does)."""
    out = [rel_norm(logits[0], want_logits[0])]
    agree = tokens[:, 0] == want_tokens[:, 0]
    out.append(rel_norm(logits[1][agree], want_logits[1][agree]) if bool(agree.any())
               else None)
    return out


def lse_compare(name: str, got: tuple, want: tuple, dtype) -> float:
    """K4's ``(o, lse)`` against another's: the same rows with no valid
    slot (lse -inf), then o and the finite lse within the dtype's
    tolerance (``compare``)."""
    (o, lse), (wo, wlse) = got, want
    empty = torch.isinf(wlse)
    check(torch.equal(torch.isinf(lse), empty), f"{name}: rows with no valid slot differ")
    err = compare(f"{name} o", o.float(), wo.float(), dtype)
    if not bool(empty.all()):
        err = max(err, compare(f"{name} lse", lse[~empty], wlse[~empty], torch.float32))
    return err


def k4_lse_timing(q, kc, vc, kpos, qpos: int, name: str, window: int = 0) -> dict:
    """K4's log-sum-exp instance timed (two runs, the faster kept) beside
    its plain version (plain, kernel, kernel, plain) and SDPA with the
    slots' mask, which computes o alone: no PyTorch call returns the
    log-sum-exp. The bound reads q and the valid slots' K and V once, and
    writes o in f32 and the log-sum-exp."""
    import torch.nn.functional as F

    b, h, hd = q.shape
    kvh = kc.shape[1]
    valid = (kpos >= 0) & (kpos <= qpos)
    if window > 0:
        valid &= kpos > qpos - window
    n_valid = int(valid.sum())
    k4 = lambda: flash_decode(q, kc, vc, kpos, qpos, window=window, return_lse=True)  # noqa
    plain = lambda: flash_decode_torch(q, kc, vc, kpos, qpos, window=window,  # noqa: E731
                                       return_lse=True)
    before = flash_decode.lse_launches
    err = lse_compare(f"flash_decode return_lse[{name}]", k4(), plain(), q.dtype)
    flash_decode.lse_launches = before                # a check, not the main path
    g = h // kvh
    q4, kct, vct = q[:, :, None], kc.repeat_interleave(g, dim=1), vc.repeat_interleave(g, dim=1)
    mask = valid[None, None, None]
    lib = lambda: F.scaled_dot_product_attention(q4, kct, vct, attn_mask=mask)  # noqa: E731
    o1, n1, n2, o2 = cuda_ms(plain), cuda_ms(k4), cuda_ms(k4), cuda_ms(plain)
    lib_ms = cuda_ms(lib)
    flash_decode.lse_launches = before
    cost = cost_model("flash_decode", b=b, h=h, kv=kvh, hd=hd, n_valid=n_valid,
                      slots=kpos.numel(), dtype=q.dtype, lse=True)
    ms = min(n1, n2)
    print(f"  K4 return_lse {name} B={b} H={h} KV={kvh} S={kc.shape[2]} valid={n_valid} "
          f"hd={hd} {q.dtype}: max_abs_err {err:.3g}; kernel {n1:.4f}/{n2:.4f} ms "
          f"({cost.bytes / ms / 1e9:.2f} TB/s), plain {o1:.4f}/{o2:.4f} ms, SDPA (o alone) "
          f"{lib_ms:.4f} ms, bound {cost.bound_ms:.5f} ms ({cost.bound_by}); {card_line()}")
    return {"shape": [b, h, kvh, kc.shape[2], hd], "valid": n_valid, "dtype": str(q.dtype),
            "max_abs_err": err, "ms": ms, "plain_ms": min(o1, o2), "bound_ms": cost.bound_ms,
            "bound_by": cost.bound_by, "library_ms": lib_ms,
            "library": "SDPA with the slots' mask, o alone (no PyTorch call returns the "
                       "log-sum-exp)"}


def k3_rank_timing(shape: tuple, dtype, window: int, label: str) -> dict:
    """K3 at a rank's prefill shape ``(B, S, H, KV, hd)``, causal with
    ``window``, on random inputs: held to its plain version, then timed
    (plain, kernel, kernel, plain) beside SDPA on the same inputs (GQA heads
    repeated outside the timed call; causal by its flag, or by an explicit
    mask with a window) and the bound over the valid (query, key) pairs."""
    import torch.nn.functional as F

    b, s, h, kvh, hd = shape
    g = torch.Generator(device=DEV).manual_seed(SEED + 67)
    q, k, v = (torch.randn(b, s, n, hd, generator=g, device=DEV).to(dtype)
               for n in (h, kvh, kvh))
    kw = dict(causal=True, window=window)
    before = flash_attention.launches
    k3 = lambda: flash_attention(q, k, v, **kw)                            # noqa: E731
    plain = lambda: flash_attention_torch(q, k, v, **kw)                   # noqa: E731
    err = compare(f"flash_attention[{label}]", k3().float(), plain().float(), dtype)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(h // kvh, dim=1).contiguous() for t in (k, v))
    pos = torch.arange(s, device=DEV)
    valid = pos[None] <= pos[:, None]
    if window:
        valid &= pos[None] > pos[:, None] - window
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid)  # noqa: E731
    else:
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    pairs = int(valid.sum())
    p1, m1, m2, p2 = cuda_ms(plain, 5, 1), cuda_ms(k3, 20), cuda_ms(k3, 20), cuda_ms(plain, 5, 1)
    lib_ms = cuda_ms(lib, 20)
    backend = sdpa_backend(lib)
    flash_attention.launches = before                 # checks, not the main path
    cost = cost_model("flash_attention", b=b, sq=s, h=h, kv=kvh, hd=hd, keys=s, pairs=pairs,
                      dtype=dtype)
    ms = min(m1, m2)
    print(f"  K3 at the {label} ranks' prefill B={b} S={s} H={h} KV={kvh} hd={hd} {dtype} "
          f"causal window={window}: max_abs_err {err:.3g}; kernel {m1:.4f}/{m2:.4f} ms "
          f"({cost.flops / ms / 1e9:.1f} TFLOP/s), plain {p1:.4f}/{p2:.4f} ms, SDPA "
          f"{lib_ms:.4f} ms ({backend}), bound {cost.bound_ms:.5f} ms ({cost.bound_by}); "
          f"{card_line()}")
    return {"shape": [b, s, h, kvh, hd], "window": window, "dtype": str(dtype),
            "max_abs_err": err, "ms": ms, "plain_ms": min(p1, p2), "bound_ms": cost.bound_ms,
            "bound_by": cost.bound_by, "library_ms": lib_ms, "library": f"SDPA, {backend}"}


def phase_k4_lse(rng) -> float:
    """[67]: K4's log-sum-exp instance against its plain version at the
    ranks' slices, and the in-process merge of 2 and 4 slices against
    whole-cache K4 and the plain version."""
    from repro_torch.sharding.parallel import merge_decode_slices

    worst = 0.0
    before = (flash_decode.launches, flash_decode.lse_launches)
    for name, b, h, kv, hd, slots, written, ring, window, n in SV_K4_CASES:
        kpos = cache_slot_positions(written, slots, ring, DEV)
        qpos = max(written - 1, 0) if written else -1
        width = slots // n
        for dtype in (torch.float32, torch.bfloat16):
            q = normal(rng, (b, h, hd), dtype)
            kc, vc = normal(rng, (b, kv, slots, hd), dtype), normal(rng, (b, kv, slots, hd), dtype)
            parts, plains = [], []
            for i in range(n):
                cut = slice(i * width, (i + 1) * width)
                args = (q, kc[:, :, cut].contiguous(), vc[:, :, cut].contiguous(),
                        kpos[cut].contiguous(), qpos)
                parts.append(flash_decode(*args, window=window, return_lse=True))
                plains.append(flash_decode_torch(*args, window=window, return_lse=True))
                worst = max(worst, lse_compare(f"K4 return_lse[{name}, slice {i}]", parts[-1],
                                               plains[-1], dtype))
            merged = merge_decode_slices([o for o, _ in parts], [l for _, l in parts], dtype)
            whole = flash_decode(q, kc, vc, kpos, qpos, window=window)
            plain = flash_decode_torch(q, kc, vc, kpos, qpos, window=window)
            e1 = compare(f"merge of {n} slices [{name}] against whole-cache K4", merged.float(),
                         whole.float(), dtype)
            e2 = compare(f"merge of {n} slices [{name}] against the plain version",
                         merged.float(), plain.float(), dtype)
            worst = max(worst, e1, e2)
            empty = sum(bool(torch.isinf(l).all()) for _, l in parts)
            print(f"  K4 return_lse {name:18s} {str(dtype):14s} B={b} H={h} KV={kv} "
                  f"S={slots} in {n} slices of {width}, written {written}, window {window}: "
                  f"{empty} slice(s) with no valid slot; merged against whole-cache K4 "
                  f"{e1:.3g}, against the plain version {e2:.3g}")
    flash_decode.launches, flash_decode.lse_launches = before
    return worst


def check_serve(label: str, per_rank: list, tol: float = 0.0, f32_bound=None,
                relative: bool = False) -> dict:
    """[68]/[69]'s checks of one job on every rank that ran it: the logits
    within ``tol`` of one device's (``relative``: plus ``SV_HOST_TOL`` of
    one device's logit, as ``torch.allclose``) and the same greedy tokens,
    or (bf16, ``f32_bound``) the prefill's and first step's logits no
    further from the f32 run's than ``f32_bound`` each."""
    runs = [r[label] for r in per_rank if label in r]
    check(runs, f"{label}: no rank ran it")
    for i, run in enumerate(runs):
        check(run["finite"], f"{label} rank {i}: logits are not finite")
        if f32_bound is not None:
            for got, bound, what in zip(run["rel_f32"], f32_bound, ("prefill", "first step")):
                check(got is not None and bound is not None,
                      f"{label} rank {i}: no row's first greedy token agrees with the f32 "
                      f"run's (rank {got}, one bf16 device {bound}): the {what} is not held")
                check(got <= bound,
                      f"{label} rank {i}: the {what}'s logits are {got:.4g} from the f32 "
                      f"run's in relative norm, one bf16 device {bound / SV_BF16_SLACK:.4g}")
        else:
            worst = max(run["excess"] if relative else run["err"])
            check(worst <= tol, f"{label} rank {i}: logits {max(run['err']):.3g} from one "
                  f"device's{f' ({worst:.3g} past {SV_HOST_TOL} of its logit)' if relative else ''}")
            check(torch.equal(run["tokens"], run["want_tokens"]),
                  f"{label} rank {i}: greedy tokens differ from one device's")
        check(run["counters_prefill"] == run["budget"]["prefill"],
              f"{label} rank {i}: prefill counters {run['counters_prefill']} against "
              f"{run['budget']['prefill']}")
        check(all(c == run["budget"]["step"] for c in run["counters_steps"]),
              f"{label} rank {i}: step counters against {run['budget']['step']}")
    return {"runs": runs}


def sv_prepare(rng) -> dict:
    """[67]'s kernel checks, then [68]-[69]'s single-device runs and their
    jobs for the shared spawn of 4 ranks."""
    print("[67] K4's log-sum-exp instance at the ranks' slices against its plain version; "
          "the merge of 2 and 4 slices against whole-cache K4; K3 at the ranks' prefill shapes")
    t0 = time.perf_counter()
    err_lse = phase_k4_lse(rng)
    k3_timed = {label: k3_rank_timing(shape, dtype, window, label)
                for label, shape, dtype, window in SV_K3_CASES}
    print(f"  [67] took {time.perf_counter() - t0:.1f} s")

    print(f"[68] sharded serving in f32 on gloo ranks sharing the card against one device: "
          f"{[j[0] for j in SV_F32_JOBS]}, {SV_GEN} greedy steps; the single-device runs "
          "(the ranks ride one spawn of 4 with [69]'s)")
    print(f"  reduced: {SV_F32_REDUCED}")
    refs, jobs = {}, {}
    for label, arch, layers, shape, ep, batch, prompt in SV_F32_JOBS:
        cfg = sv_config(arch, layers)
        key = (arch, batch, prompt)
        if key not in refs:
            refs[key] = sv_reference(label, cfg, batch, prompt, SV_GEN)
        jobs[label] = {"kind": "serve", "label": label, "cfg": cfg, "ep": ep, "batch": batch,
                       "prompt": prompt, "gen": SV_GEN, "ref": refs[key]["path"]}
    bf_cfg = sv_config(LM_ARCH, SV_BF16_LAYERS, "bfloat16")
    print(f"[69] one device, {LM_ARCH} at its widths, {SV_BF16_LAYERS} layers, bf16, "
          f"{SV_BF16_BATCH} x {SV_BF16_PROMPT} + {SV_BF16_GEN} greedy steps; reduced: "
          f"{SV_BF16_REDUCED}")
    bf_ref = sv_reference("bf16", bf_cfg, SV_BF16_BATCH, SV_BF16_PROMPT, SV_BF16_GEN)
    f32_ref = sv_reference("bf16's f32", bf_cfg.replace(dtype="float32"), SV_BF16_BATCH,
                           SV_BF16_PROMPT, 1)
    one = [torch.load(r["path"], weights_only=True) for r in (bf_ref, f32_ref)]
    one_rel = first_steps_rel(one[0]["logits"][:2], one[0]["tokens"], one[1]["logits"],
                              one[1]["tokens"])
    f32_bound = [None if x is None else SV_BF16_SLACK * x for x in one_rel]
    del one
    for shape in SV_BF16_MESHES:
        jobs[f"bf16 {shape}"] = {"kind": "serve", "label": f"bf16 {shape}", "cfg": bf_cfg,
                                 "ep": False, "batch": SV_BF16_BATCH,
                                 "prompt": SV_BF16_PROMPT, "gen": SV_BF16_GEN,
                                 "ref": bf_ref["path"], "ref_f32": f32_ref["path"],
                                 "warm": True}
    spawn = [{"shape": (1, 2), "blocks": [jobs["qwen (1, 2)"], jobs["mixtral tp (1, 2)"]]},
             {"shape": (1, 2), "blocks": [jobs["mixtral ep (1, 2)"], None]},
             {"shape": (1, 4), **jobs["qwen (1, 4)"]},
             {"shape": (1, 2), "blocks": [jobs["bf16 (1, 2)"], None]},
             {"shape": (1, 4), **jobs["bf16 (1, 4)"]}]
    return {"refs": list(refs.values()) + [bf_ref, f32_ref], "spawn": spawn, "jobs": jobs,
            "bf_ref": bf_ref, "f32_bound": f32_bound, "one_rel": one_rel, "refs_by": refs,
            "err_lse": err_lse, "k3": k3_timed}


def sv_checks(prep: dict, ranks: list) -> list:
    """[68]-[69]'s checks of the spawn's ranks, each timed; returns K4's
    log-sum-exp rows (its instance at [69]'s rank slices) and K3's at
    [67]'s prefill shapes, each with its launches per rank."""
    print("[68] sharded serving in f32 against one device, on the shared spawn's ranks")
    t0 = time.perf_counter()
    refs, bf_ref = prep["refs_by"], prep["bf_ref"]
    f32_bound, one_rel, err_lse = prep["f32_bound"], prep["one_rel"], prep["err_lse"]
    for label, arch, layers, shape, ep, batch, prompt in SV_F32_JOBS:
        got = check_serve(label, ranks, SV_HOST_TOL)
        ref = refs[(arch, batch, prompt)]
        r0 = got["runs"][0]
        print(f"  {label}, {arch} at {layers} layer(s), {batch} x {prompt} + {SV_GEN}: max "
              f"|logit diff| {max(max(r['err']) for r in got['runs']):.3g} (tolerance "
              f"{SV_HOST_TOL}); tokens identical; prefill "
              f"{[round(r['prefill_ms'], 1) for r in got['runs']]} ms, step "
              f"{[round(r['step_ms'], 2) for r in got['runs']]} ms by rank (one device "
              f"{ref['prefill_ms']:.1f} / {ref['step_ms']:.2f}); cache "
              f"{r0['cache_bytes'] / 1e6:.2f} MB per rank (one device "
              f"{ref['cache_bytes'] / 1e6:.2f}); launches per rank {r0['launches']}; "
              f"counters equal the budget; {card_line()}")
    sv_nccl(get_config(LM_ARCH).replace(**serve_mod.SCALES[TP_NCCL_SCALE]))
    print(f"  [68] checks took {time.perf_counter() - t0:.1f} s")

    print(f"[69] bf16 on (1, 2) and (1, 4) against one device ({card_line()})")
    t0 = time.perf_counter()
    nl = SV_BF16_LAYERS
    print(f"  one device: prefill {bf_ref['prefill_ms']:.1f} ms, {bf_ref['step_ms']:.2f} "
          f"ms/step, peak {bf_ref['peak_gb']:.2f} GB, cache {bf_ref['cache_bytes'] / 1e6:.1f} "
          f"MB, launches prefill {bf_ref['launches_prefill']}, decode "
          f"{bf_ref['launches_decode']}")
    rows = []
    for shape in SV_BF16_MESHES:
        label = f"bf16 {shape}"
        runs = check_serve(label, ranks, f32_bound=f32_bound)["runs"]
        m = shape[1]
        for i, run in enumerate(runs):
            check(run["launches_prefill"]["flash_attention"] == nl,
                  f"{label} rank {i}: K3 {run['launches_prefill']} per prefill, want {nl}")
            check(run["launches_decode"]["flash_decode_lse"] == nl * SV_BF16_GEN
                  and run["launches_decode"]["flash_decode"] == 0,
                  f"{label} rank {i}: K4 {run['launches_decode']} over the steps, want "
                  f"{nl} of its log-sum-exp instance per step")
            check(run["cache_bytes"] * m == bf_ref["cache_bytes"],
                  f"{label} rank {i}: cache {run['cache_bytes']} B, one device's "
                  f"{bf_ref['cache_bytes']} over {m}")
        agree = [int((r["tokens"] == r["want_tokens"]).sum()) for r in runs]
        print(f"  {label}: prefill {[round(r['prefill_ms'], 1) for r in runs]} ms, "
              f"{[round(r['step_ms'], 2) for r in runs]} ms/step, peak while serving "
              f"{[round(r['peak_gb'], 2) for r in runs]} GB, cache "
              f"{[round(r['cache_bytes'] / 1e6, 1) for r in runs]} MB by rank (1/{m} of one "
              f"device's); K3 {runs[0]['launches_prefill']['flash_attention']} per prefill and "
              f"K4 {runs[0]['launches_decode']['flash_decode_lse'] // SV_BF16_GEN} per step "
              f"on each rank; prefill logits {max(r['err'][0] for r in runs):.3g} from one "
              f"device's (relative norm, prefill and first step on the rows whose first "
              f"token agrees: {[r['rel_one'] for r in runs]}); against the f32 run "
              f"{[r['rel_f32'] for r in runs]} (one bf16 device {one_rel}); "
              f"greedy tokens agreeing with one device's {agree} of "
              f"{runs[0]['tokens'].numel()} per rank; {card_line()}")
        slots = (SV_BF16_PROMPT + SV_BF16_GEN) // m
        g = torch.Generator(device=DEV).manual_seed(SEED + 69)
        q = torch.randn(SV_BF16_BATCH, 40, 128, generator=g, device=DEV).to(torch.bfloat16)
        kc, vc = (torch.randn(SV_BF16_BATCH, 8, slots, 128, generator=g,
                              device=DEV).to(torch.bfloat16) for _ in range(2))
        kpos = cache_slot_positions(SV_BF16_PROMPT + 1, SV_BF16_PROMPT + SV_BF16_GEN,
                                    False, DEV)[:slots].contiguous()
        timed = k4_lse_timing(q, kc, vc, kpos, SV_BF16_PROMPT, f"rank slice of {shape}")
        timed["max_abs_err"] = max(timed["max_abs_err"], err_lse)
        launches = runs[0]["launches_decode"]["flash_decode_lse"]
        rows.append({"name": f"flash_decode return_lse (Qwen2.5-14B serving, rank slice of "
                             f"{shape})", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
                     "replaces": "src/repro/kernels/flash_decode.py:88", "launches": launches,
                     "launches_per_step": launches // SV_BF16_GEN, **timed})
    for label, shape, dtype, window in SV_K3_CASES:
        runs = [r[label] for r in ranks if label in r]
        launches = runs[0]["launches"]["flash_attention"]
        check(all(r["launches"]["flash_attention"] == launches for r in runs),
              f"{label}: K3's launches differ across ranks")
        rows.append({"name": f"flash_attention (sharded serving prefill, {label}, a rank's "
                             "heads)", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:100",
                     "launches": launches, **prep["k3"][label]})
    check(all(r["launches"] > 0 for r in rows), "[68]/[69]: K3 or K4's log-sum-exp instance "
          "was not launched on the main path at a rank's shape")
    print(f"  [69] took {time.perf_counter() - t0:.1f} s")
    return rows


def phase_serve_tp_slice(kernels: list, rng, extra: list = ()) -> tuple:
    """[67]-[69]: [67]'s kernel checks and the single-device runs, one spawn
    of 4 gloo ranks for every serving job (and the ``extra`` entries,
    [72]'s jobs), then the checks; K4's log-sum-exp rows and the world's
    results."""
    t0 = time.perf_counter()
    sv = sv_prepare(rng)
    k3 = next(e for e in kernels if e["name"] == "flash_attention")
    k3["max_abs_err"] = max([k3["max_abs_err"]] + [t["max_abs_err"] for t in sv["k3"].values()])
    # [74] (c): rides this spawn, held to the one-device run of its [68] job
    label, shape, layout, like, gen = LY_SERVE
    ly_job = dict(sv["jobs"][like], label=label, layout=layout, shape=shape, gen=gen)
    try:
        ranks = run_tp(4, sv["spawn"] + list(extra) + [ly_job])
    finally:
        for ref in sv["refs"]:
            Path(ref["path"]).unlink(missing_ok=True)
    print(f"  [68]-[69]'s single-device runs and the spawn took "
          f"{time.perf_counter() - t0:.1f} s")
    return sv_checks(sv, ranks), ranks


# ---------------------------------------------------------------------------
# [70]: the row-sparse transport on a vocabulary split over model
# ---------------------------------------------------------------------------


def phase_sparse_tp(kernels: list, sparse: dict) -> list:
    """[70]: the sparse jobs that rode [64]'s spawn, held to one device
    (``check_tp``: losses, parameters, updates, whole leaves, ``sub_rows``,
    uplink bytes, K3's and K1's launches) and to ``tp_collective_budget``;
    K1 at the (2, 2) rank's slice shape against its plain version and
    timed. Returns K1's row at that shape."""
    print(f"[70] {LM_ARCH} at its widths, f32, fedsubavg on the row-sparse transport, "
          f"{TP_ROUNDS} rounds of {TP_RUN}, the vocabulary split over 'model' on "
          f"{', '.join(str(m) for m in SP_MESHES)} (gloo ranks sharing the card, run in "
          "[64]'s spawn) against one device")
    t0 = time.perf_counter()
    print(f"  reduced: {SP_REDUCED}")
    ref = sparse["ref"]
    print(f"  one device: sub_rows {ref['sub_rows']}, uplink {ref['bytes_up']} B a round")
    per_rank = {}
    for label, ranks in sparse["jobs"].items():
        per_rank[label] = check_tp(label, ranks, ref)["launches"]["union_segsum"]
        check_budget(label, ranks)
        check(per_rank[label] == TP_ROUNDS, f"{label}: K1 launched {per_rank[label]} times "
              f"a rank, want one a round")
    label = f"{LM_ARCH} sparse {SP_K1_MESH}"
    got = next(per[label] for per in sparse["jobs"][label] if "k1_args" in per[label])
    ids, rows, heat, total, cap, v = (a.to(DEV) if isinstance(a, torch.Tensor) else a
                                      for a in got["k1_args"])
    args, scale = (ids, rows, heat, total, cap, v), got["k1_kw"]["scale"]
    union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
    err = check_k1(f"union_segsum[{label} slice]", args, scale, union)
    print(f"  K1 at the slice of a {SP_K1_MESH} rank: V/m={v} T={ids.numel()} "
          f"D={rows.shape[-1]} cap={cap} union={union} max_abs_err={err:.3g}")
    timed = time_k1_k2(args, scale, f"[{SP_K1_MESH} slice]", keys=("k1",), profile=False)
    k1 = next(e for e in kernels if e["name"] == "union_segsum")
    k1["max_abs_err"] = max(k1["max_abs_err"], err)
    del args, ids, rows, heat
    print(f"  [70] took {sparse['s'] + time.perf_counter() - t0:.1f} s ({sparse['s']:.1f} s "
          f"of it its runs within [64]; {card_line()})")
    return [{"name": f"union_segsum (Qwen2.5-14B sparse round, slice of a {SP_K1_MESH} rank, "
                     f"{timed['shape']})", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/union_segsum.cu",
             "replaces": "src/repro/kernels/union_segsum.py:170",
             "launches": per_rank[label], "launches_per_round": per_rank[label] // TP_ROUNDS,
             "max_abs_err": err, **{k: timed["k1"][k] for k in (
                 "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}]


# ---------------------------------------------------------------------------
# [71]-[73]: Whisper, Zamba2 and xLSTM trained and served on a (data, model) mesh
# ---------------------------------------------------------------------------

#: the families at their published widths, their depth cut for time (the
#: kinds of layer kept): key -> (arch, overrides, the cut)
FAM_MODELS = {
    "zamba2": (ZAMBA_ARCH, dict(num_layers=6),
               "Mamba2 layers 38 -> 6, keeping its one shared-attention site (attn_every 6)"),
    "xlstm": (XLSTM_ARCH, dict(num_layers=8),
              "blocks 24 -> 8 (the pattern's first 8: its sLSTM block at index 4)"),
    "whisper": (WH_ARCH, dict(num_layers=2, encoder_layers=2),
                "encoder 32 -> 2 and decoder 32 -> 2 layers, encoder_seq 1,500"),
}
#: [71]'s corpus, cohort and rounds: 4 sequences of 128 tokens, so that a
#: (1, 2) rank's Whisper encoder runs K3 at B 4 x 1,500 frames
FAM_RUN = dict(clients=64, cohort=4, seq=128, zipf_a=1.3, lr=LM_LR, algorithm="fedsubavg")
FAM_ROUNDS = 2
#: [71]'s jobs of each family: the dense and the row-sparse transport at
#: once on the world's two (1, 2) meshes, then the row-sparse on (2, 2)
FAM_TRAIN_JOBS = (((1, 2), False), ((1, 2), True), ((2, 2), True))
#: [72]: each family served in f32 and bf16 on these meshes, 2 prompts of
#: 128 tokens (xLSTM's prefill takes up to its 256-token chunk) and 4
#: greedy steps
FAM_SV_BATCH, FAM_SV_PROMPT, FAM_SV_GEN = 2, 128, 4
FAM_SV_MESHES = ((1, 2), (1, 4))
#: [72]: the ranks' bf16 logits are held to the f32 run no further than
#: this times one bf16 device's distance from it ([69]'s slack for
#: Whisper's attention layers). Through the recurrent mixers a bf16 run
#: that rounds in another order (a rank's row-parallel partials are
#: rounded before their sum) lands farther from f32 or nearer: on an H100
#: at 128-token prompts Zamba2's (1, 2) ranks were 0.0633 / 0.0365 (prefill
#: / first step) from it and its (1, 4) ranks 0.0879 / 0.0436, against one
#: device's 0.0416 / 0.0338 (2.11x at most); xLSTM's 0.0860-0.0898 /
#: 0.0652-0.0703 against 0.0791 / 0.0684 (PERF.md §6). A split that broke
#: the arithmetic would land ~1 away
FAM_BF16_SLACK = {"whisper": SV_BF16_SLACK, "zamba2": 2.5, "xlstm": 2.5}
#: [72]: a broken split that the f32 bound must fail, served once on the
#: ranks of this job: the first Mamba2 layer's ``out_proj`` with its row
#: blocks over ``model`` swapped (each rank's heads meet the other's rows)
FAM_SV_SWAP = ("zamba2 f32 (1, 2)", "mamba.0.out_proj", 0)
#: [73]: K3 and its backward at [71]'s ranks' training shapes (label, (B,
#: S, H, KV, hd), keys or None, causal, the job whose ranks launch it)
FAM_K3_TRAIN = (
    ("Whisper encoder, rank of (1, 2)", (4, 1500, 10, 10, 64), None, False,
     "whisper dense (1, 2)"),
    ("Whisper cross-attention, rank of (1, 2)", (4, 128, 10, 10, 64), 1500, False,
     "whisper dense (1, 2)"),
    ("Zamba2 shared attention, rank of (2, 2)", (2, 128, 16, 16, 64), None, True,
     "zamba2 sparse (2, 2)"),
)
#: [73]: K3 in bf16 at [72]'s ranks' prefill shapes (label, (B, Sq, Sk, H,
#: KV, hd), causal, the job)
FAM_K3_SERVE = (
    ("Whisper encoder prefill, rank of (1, 4)", (2, 1500, 1500, 5, 5, 64), False,
     "whisper bf16 (1, 4)"),
    ("Zamba2 prefill, rank of (1, 2)", (2, 128, 128, 16, 16, 64), True,
     "zamba2 bf16 (1, 2)"),
)
#: [73]: K4's log-sum-exp instance in bf16 at hd 64 on [72]'s ranks'
#: slices (label, B, H, KV, slots of the slice, positions valid in it, the
#: job)
FAM_K4 = (
    ("Whisper cross-attention, rank slice of (1, 2)", 2, 20, 20, 750, 750, "whisper bf16 (1, 2)"),
    ("Whisper self-attention, rank slice of (1, 4)", 2, 20, 20, 33, 33, "whisper bf16 (1, 4)"),
    ("Zamba2 shared attention, rank slice of (1, 2)", 2, 32, 32, 66, 66,
     "zamba2 bf16 (1, 2)"),
)


def fam_config(key: str, dtype: str = "float32"):
    arch, over, _ = FAM_MODELS[key]
    cfg = get_config(arch).replace(dtype=dtype, **over)
    if cfg.family == "ssm":
        cfg = cfg.replace(block_pattern=cfg.block_pattern[:cfg.num_layers])
    return cfg


def fam_train_prepare() -> dict:
    """[71]'s jobs for [64]'s spawn: each family on each transport, its
    single-device run made by each rank before its mesh run (``tp_job``'s
    ``inline``: the references are never written to disk)."""
    print(f"[71] Whisper, Zamba2 and xLSTM at their published widths, f32, fedsubavg, "
          f"{FAM_ROUNDS} rounds of {FAM_RUN}: on "
          f"{[f'{s} ' + ('sparse' if sp else 'dense') for s, sp in FAM_TRAIN_JOBS]} meshes "
          "of gloo ranks sharing the card, in [64]'s spawn, each rank first making the "
          "single-device run; each mesh's second round starts from one device's "
          "first-round parameters")
    jobs, spawn = {}, []
    for key, (_, _, cut) in FAM_MODELS.items():
        cfg = fam_config(key)
        print(f"  {key} reduced: {cut}")
        for shape, sparse in FAM_TRAIN_JOBS:
            label = f"{key} {'sparse' if sparse else 'dense'} {shape}"
            jobs[label] = {"label": label, "shape": shape, "cfg": cfg, "ep": False,
                           "inline": True, "rounds": FAM_ROUNDS, "sparse": sparse,
                           "run": FAM_RUN, "key": key}
        spawn.append({"shape": (1, 2), "blocks": [jobs[f"{key} dense (1, 2)"],
                                                  jobs[f"{key} sparse (1, 2)"]]})
        spawn.append(jobs[f"{key} sparse (2, 2)"])
    return {"jobs": jobs, "spawn": spawn}


def phase_fam_train(fam: dict, world: list) -> dict:
    """[71]'s checks of the jobs that rode [64]'s spawn: each held to the
    single-device run its ranks made (``check_tp``: losses and every leaf
    after each round, updates, whole leaves, ``sub_rows`` and uplink
    bytes, K3's, its backward's and K1's launches per rank) and to
    ``tp_collective_budget``. Returns each job's launches per rank."""
    print("[71] the families' sharded rounds against one device (their ranks ran in "
          "[64]'s spawn)")
    t0 = time.perf_counter()
    launches = {}
    for label, job in fam["jobs"].items():
        ranks = [per for per in world if label in per]
        # each rank's parameters are held to its own single-device run; two
        # such runs differ in the embedding gradient's unordered adds
        ref = ranks[0][label]["ref"]
        for r, per in enumerate(ranks):
            check(np.allclose(per[label]["ref"]["losses"], ref["losses"], rtol=LM_HOST_TOL,
                              atol=LM_HOST_TOL),
                  f"{label} rank {r}: its single-device run's losses "
                  f"{per[label]['ref']['losses']} against rank 0's {ref['losses']}")
        print(f"  {label}, one device: loss {[round(x, 6) for x in ref['losses']]}, ms/round "
              f"{[round(x, 1) for x in ref['ms']]}, peak {ref['peak_gb']:.2f} GB, launches "
              f"{ref['launches']}")
        got = check_tp(label, ranks, ref)
        check_budget(label, ranks)
        err1 = max(max(per[label]["err1"].values()) for per in ranks)
        job_s = max(per[label]["s"] for per in ranks)
        print(f"    after the first round, max |param diff| {err1:.3g}; the job took "
              f"{job_s:.1f} s a rank (its single-device run included)")
        if job["sparse"]:
            check(got["launches"]["union_segsum"] == FAM_ROUNDS,
                  f"{label}: K1 launched {got['launches']['union_segsum']} times a rank, "
                  "want one a round")
        launches[label] = got["launches"]
    print(f"  [71] checks took {time.perf_counter() - t0:.1f} s ({card_line()})")
    return launches


def fam_rank_cache_bytes(cfg, one: int, m: int) -> int:
    """A rank's cache bytes on a (1, m) mesh, from one device's: 1/m of
    it, but xLSTM's stabilisers, which ``cache_specs`` keeps whole."""
    whole = 0
    if cfg.family == "ssm":
        whole = cfg.block_pattern.count("m") * FAM_SV_BATCH * cfg.ssm_heads * 4
    return (one - whole) // m + whole


def fam_sv_launches(cfg) -> tuple:
    """K3's launches per prefill and K4's log-sum-exp instance's per step
    on a rank whose caches are split by sequence."""
    if cfg.family == "audio":
        return cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    if cfg.family == "hybrid":
        sites = cfg.num_layers // cfg.attn_every
        return sites, sites
    return 0, 0


def fam_serve_prepare() -> dict:
    """[72]'s single-device runs, each family in f32 and bf16, and its jobs
    for [67]'s spawn."""
    print(f"[72] Whisper, Zamba2 and xLSTM served at their published widths (the depths of "
          f"[71]), f32 and bf16, {FAM_SV_BATCH} x {FAM_SV_PROMPT} + {FAM_SV_GEN} greedy "
          f"steps: one device (here), then {list(FAM_SV_MESHES)} meshes in [67]'s spawn")
    t0 = time.perf_counter()
    refs, jobs, spawn, bound = {}, {}, [], {}
    for key in FAM_MODELS:
        for dtype in ("float32", "bfloat16"):
            refs[key, dtype] = sv_reference(f"fam {key} {dtype}", fam_config(key, dtype),
                                            FAM_SV_BATCH, FAM_SV_PROMPT, FAM_SV_GEN)
        one = [torch.load(refs[key, d]["path"], weights_only=True)
               for d in ("bfloat16", "float32")]
        rel = first_steps_rel(one[0]["logits"][:2], one[0]["tokens"], one[1]["logits"],
                              one[1]["tokens"])
        bound[key] = {"one": rel, "bound": [None if x is None else FAM_BF16_SLACK[key] * x
                                            for x in rel]}
        for shape in FAM_SV_MESHES:
            for dtype in ("float32", "bfloat16"):
                label = f"{key} {'f32' if dtype == 'float32' else 'bf16'} {shape}"
                jobs[label] = {"kind": "serve", "label": label, "shape": shape,
                               "cfg": fam_config(key, dtype), "ep": False,
                               "batch": FAM_SV_BATCH, "prompt": FAM_SV_PROMPT,
                               "gen": FAM_SV_GEN, "ref": refs[key, dtype]["path"],
                               "ref_f32": (refs[key, "float32"]["path"]
                                           if dtype == "bfloat16" else None),
                               "key": key, "dtype": dtype}
                if label == FAM_SV_SWAP[0]:
                    jobs[label]["swap"] = FAM_SV_SWAP[1:]
        spawn.append({"shape": (1, 2), "blocks": [jobs[f"{key} f32 (1, 2)"],
                                                  jobs[f"{key} bf16 (1, 2)"]]})
        spawn += [jobs[f"{key} f32 (1, 4)"], jobs[f"{key} bf16 (1, 4)"]]
    s = time.perf_counter() - t0
    print(f"  [72]'s single-device runs took {s:.1f} s")
    return {"refs": list(refs.values()), "refs_by": refs, "jobs": jobs, "spawn": spawn,
            "bound": bound, "s": s}


def phase_fam_serve(fam: dict, world: list) -> dict:
    """[72]'s checks of the jobs that rode [67]'s spawn: f32 logits within
    ``SV_HOST_TOL`` plus ``SV_HOST_TOL`` of one device's logit (as [52])
    and the same greedy tokens, and ``FAM_SV_SWAP``'s broken split outside
    that bound; bf16 held to the f32 run as [69] holds it,
    with ``FAM_BF16_SLACK``; counters equal
    ``serve_collective_budget``; K3 and K4's log-sum-exp instance on every
    rank; each rank's cache 1/m of one device's where its dims divide.
    Returns each job's launches per rank."""
    print("[72] the families served on (1, 2) and (1, 4) against one device (their ranks "
          "ran in [67]'s spawn)")
    t0 = time.perf_counter()
    launches = {}
    for label, job in fam["jobs"].items():
        key, dtype, cfg = job["key"], job["dtype"], job["cfg"]
        ref = fam["refs_by"][key, dtype]
        if dtype == "float32":
            # as [52] holds these models' full-width f32 logits card against
            # host: within 1e-4 plus 1e-4 of the logit
            runs = check_serve(label, world, SV_HOST_TOL, relative=True)["runs"]
        else:
            runs = check_serve(label, world, f32_bound=fam["bound"][key]["bound"])["runs"]
        k3, k4 = fam_sv_launches(cfg)
        m = job["shape"][1]
        want_bytes = fam_rank_cache_bytes(cfg, ref["cache_bytes"], m)
        for i, run in enumerate(runs):
            check(run["launches_prefill"]["flash_attention"] == k3,
                  f"{label} rank {i}: K3 {run['launches_prefill']} per prefill, want {k3}")
            check(run["launches_decode"]["flash_decode_lse"] == k4 * FAM_SV_GEN
                  and run["launches_decode"]["flash_decode"] == 0,
                  f"{label} rank {i}: K4 {run['launches_decode']} over the steps, want {k4} "
                  "of its log-sum-exp instance a step")
            check(run["cache_bytes"] == want_bytes,
                  f"{label} rank {i}: cache {run['cache_bytes']} B, want {want_bytes} (one "
                  f"device's {ref['cache_bytes']})")
        if dtype == "float32":
            held = (f"max |logit diff| {max(max(r['err']) for r in runs):.3g} (past 1e-4 of "
                    f"the logit by at most {max(max(r['excess']) for r in runs):.3g}; max "
                    f"|logit| {max(r['scale'] for r in runs):.3g}); tokens identical")
            if job.get("swap"):
                bad = [r["swapped"] for r in runs]
                check(all(b["excess"] > SV_HOST_TOL for b in bad),
                      f"{label}: a split with {job['swap'][0]}'s blocks swapped passed the "
                      f"bound ({bad})")
                held += (f"; with {job['swap'][0]}'s blocks swapped, the prefill's max |logit "
                         f"diff| {max(b['err'] for b in bad):.3g} (past 1e-4 of the logit by "
                         f"{min(b['excess'] for b in bad):.3g} or more)")
        else:
            held = (f"prefill and first step against the f32 run {[r['rel_f32'] for r in runs]}"
                    f" (one bf16 device {fam['bound'][key]['one']})")
        print(f"  {label}: {held}; prefill {[round(r['prefill_ms'], 1) for r in runs]} ms, "
              f"{[round(r['step_ms'], 2) for r in runs]} ms/step by rank (one device "
              f"{ref['prefill_ms']:.1f} / {ref['step_ms']:.2f}); cache "
              f"{runs[0]['cache_bytes'] / 1e6:.2f} MB a rank (one device "
              f"{ref['cache_bytes'] / 1e6:.2f}); K3 {k3} per prefill, K4 {k4} per step on "
              f"every rank; counters equal the budget; {card_line()}")
        launches[label] = {"flash_attention": runs[0]["launches_prefill"]["flash_attention"],
                           "flash_decode_lse": runs[0]["launches_decode"]["flash_decode_lse"]}
    print(f"  [72] checks took {time.perf_counter() - t0:.1f} s ({fam['s']:.1f} s of "
          "single-device runs before [67])")
    return launches


def phase_fam_kernels(kernels: list, launches: dict) -> list:
    """[73]: K3 and its backward at [71]'s ranks' training shapes, K3 in
    bf16 at [72]'s ranks' prefill shapes and K4's log-sum-exp instance at
    hd 64 on their slices, each held to its plain version (``compare``:
    2e-5 f32, 2e-2 bf16) and timed beside it, SDPA and its bound. Returns
    their rows, each with its launches per rank in the job that runs it."""
    print("[73] K3, its backward and K4's log-sum-exp instance at the families' per-rank "
          "shapes")
    t0 = time.perf_counter()
    by_name = {e["name"]: e for e in kernels}
    rows = []
    for i, (label, shape, sk, causal, job) in enumerate(FAM_K3_TRAIN):
        fwd, bwd = train_attention_timing(shape, SEED + 73 + i, label, sk=sk, causal=causal)
        per_rank = launches[job]
        for kernel, timed, source in (
                ("flash_attention", fwd, ("flash_attention.cu",
                                          "src/repro/kernels/flash_attention.py:100")),
                ("flash_attention_bwd", bwd, ("flash_attention_bwd.cu",
                                              "src/repro/models/layers.py:154"))):
            by_name[kernel]["max_abs_err"] = max(by_name[kernel]["max_abs_err"],
                                                 timed["max_abs_err"])
            rows.append({"name": f"{kernel} ({label}, {job} training)", "route": "cuda",
                         "source": f"src/repro_torch/kernels/csrc/{source[0]}",
                         "replaces": source[1], "launches": per_rank[kernel],
                         "launches_per_round": per_rank[kernel] // FAM_ROUNDS, **timed})
    g = torch.Generator(device=DEV).manual_seed(SEED + 73)
    for label, (b, sq, sk, h, kvh, hd), causal, job in FAM_K3_SERVE:
        q = torch.randn(b, sq, h, hd, generator=g, device=DEV).to(torch.bfloat16)
        k, v = (torch.randn(b, sk, kvh, hd, generator=g, device=DEV).to(torch.bfloat16)
                for _ in range(2))
        timed = wh_k3_timing(q, k, v, causal, label)
        by_name["flash_attention"]["max_abs_err"] = max(by_name["flash_attention"]["max_abs_err"],
                                                        timed["max_abs_err"])
        rows.append({"name": f"flash_attention ({label}, {job} serving)", "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                     "replaces": "src/repro/kernels/flash_attention.py:100",
                     "launches": launches[job]["flash_attention"], **timed})
    for label, b, h, kvh, slots, valid, job in FAM_K4:
        q = torch.randn(b, h, 64, generator=g, device=DEV).to(torch.bfloat16)
        kc, vc = (torch.randn(b, kvh, slots, 64, generator=g, device=DEV).to(torch.bfloat16)
                  for _ in range(2))
        kpos = torch.arange(slots, dtype=torch.int32, device=DEV)
        kpos = torch.where(kpos < valid, kpos, -1).to(torch.int32)
        timed = k4_lse_timing(q, kc, vc, kpos, slots, label)
        n = launches[job]["flash_decode_lse"]
        rows.append({"name": f"flash_decode return_lse ({label}, {job} serving)",
                     "route": "cuda", "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
                     "replaces": "src/repro/kernels/flash_decode.py:88", "launches": n,
                     "launches_per_step": n // FAM_SV_GEN, **timed})
    check(all(r["launches"] > 0 for r in rows), "[73]: a kernel was not launched on the main "
          "path at a family's per-rank shape")
    print(f"  [73] took {time.perf_counter() - t0:.1f} s ({card_line()})")
    return rows


def sv_nccl(cfg) -> None:
    """[68] (b): a 1-rank NCCL ``(1, 1)`` mesh in this process serving as
    one device does, its counters the budget's."""
    kw = dict(batch=2, prompt=256, gen=8, seed=SEED)
    single = serve_mod.serve(cfg, device=DEV, **kw)
    store = Path(tempfile.mkdtemp(prefix="nccl_", dir=ROOT / "build"))
    mesh = make_device_mesh((1, 1), device=DEV, backend="nccl",
                            init_method=f"file://{store / 's'}", rank=0, world_size=1)
    try:
        res = serve_mod.serve(cfg, mesh=mesh, **kw)
        budget = plan_mod.serve_collective_budget(cfg, mesh, 2, 256, 8, rules=res.rules)
    finally:
        mesh.destroy()
        shutil.rmtree(store, ignore_errors=True)
    err = max(float((a - b).abs().max()) for a, b in zip(res.logits, single.logits))
    check(err <= LM_STEP_TOL, f"NCCL (1, 1) serving: logits {err:.3g} from one device's")
    check(torch.equal(res.tokens, single.tokens), "NCCL (1, 1) serving: tokens differ")
    check(res.counters_prefill == budget["prefill"]
          and all(c == budget["step"] for c in res.counters_steps),
          f"NCCL (1, 1) serving: counters {res.counters_prefill} against {budget}")
    print(f"  NCCL (1, 1), {cfg.name} at the {TP_NCCL_SCALE} scale, 2 x 256 + 8: max |logit "
          f"diff| {err:.3g}; tokens identical; counters equal the budget; {card_line()}")


# ---------------------------------------------------------------------------
# [74]: the dry run's other layouts: FSDP and the multi-pod mesh
# ---------------------------------------------------------------------------

#: [74]'s K3 and K3-backward rows, a rank's training shape no earlier row
#: has: (label, (B, S, H, KV, hd)); [74]'s training jobs all run it
LY_K3_CASE = ("Qwen2.5-14B, a rank of (2, 2) or (2, 1, 2)", (4, 128, 20, 4, 128))


def phase_layouts(kernels: list, lay: dict, sv_world: list) -> list:
    """[74]: the layout jobs that rode [64]'s and [67]'s spawns held as
    [64], [66], [68] and [70] hold theirs (losses and parameters 1e-4,
    updates 1e-3, whole leaves bit for bit, ``sub_rows`` and uplink,
    launches per rank, counters equal the budgets; served f32 logits 1e-4
    and tokens identical); each rank's resident parameter bytes and peak
    under FSDP against TP on (2, 2); K3, its backward and K4's log-sum-exp
    instance at the ranks' new shapes against their plain versions, timed.
    Returns their rows."""
    print("[74] the dry run's other layouts, gloo ranks sharing the card, against one "
          "device: FSDP (each weight's d_model also split over 'data', gathered per layer; "
          "its gradient reduce-scattered) and the multi-pod (pod, data, model) mesh (the "
          "cohort over pod and data)")
    t0 = time.perf_counter()
    by_name = {e["name"]: e for e in kernels}
    launches = {}
    for label, ranks in lay["jobs"].items():
        launches[label] = check_tp(label, ranks, lay["refs"][label])["launches"]
        check_budget(label, ranks)
        b = ranks[0][label]["budget"]
        print(f"    per rank per round: "
              f"fsdp_gather {b['data'].get('fsdp_gather', {}).get('bytes', 0) / 1e6:.1f} MB, "
              f"fsdp_grad {b['data'].get('fsdp_grad', {}).get('bytes', 0) / 1e6:.1f} MB; "
              + ", ".join(f"'{axis}' {sum(c['bytes'] for c in tags.values()) / 1e6:.2f} MB"
                          for axis, tags in b.items()))
    tp_label, fsdp_label = f"{LM_ARCH} (2, 2)", f"{LM_ARCH} fsdp (2, 2)"
    resident = {}
    for label, ranks in ((tp_label, lay["tp"][tp_label]["ranks"]),
                         (fsdp_label, lay["jobs"].get(fsdp_label, []))):
        if not ranks:
            continue
        resident[label] = [per[label]["resident_gb"] for per in ranks]
        print(f"  {label}, 1 layer: each rank's resident parameters "
              f"{[round(x, 4) for x in resident[label]]} GB, its peak from keeping its part "
              f"(the whole draw freed) to the round's end "
              f"{[round(per[label]['peak_gb'], 3) for per in ranks]} GB; {card_line()}")
    if len(resident) == 2:
        check(max(resident[fsdp_label]) < min(resident[tp_label]),
              "[74]: an FSDP rank holds no less than a TP rank")
    label, shape, layout, like, gen = LY_SERVE
    runs = check_serve(label, sv_world, SV_HOST_TOL)["runs"]
    r0 = runs[0]
    print(f"  {label}, as [68]'s {like!r} for {gen} steps: max |logit diff| "
          f"{max(max(r['err']) for r in runs):.3g} (tolerance {SV_HOST_TOL}); tokens "
          f"identical; prefill {[round(r['prefill_ms'], 1) for r in runs]} ms, step "
          f"{[round(r['step_ms'], 2) for r in runs]} ms by rank; resident parameters "
          f"{[round(r['resident_gb'], 4) for r in runs]} GB, peak while serving "
          f"{[round(r['peak_gb'], 3) for r in runs]} GB by rank; launches per rank "
          f"{r0['launches']}; counters equal the budget "
          f"({r0['budget']['step']['data']['fsdp_gather']['bytes'] / 1e6:.1f} MB gathered "
          f"over 'data' a step); {card_line()}")
    rows = []
    name, k3_shape = LY_K3_CASE
    fwd, bwd = train_attention_timing(k3_shape, SEED + 74, name)
    for kernel, timed, source in (
            ("flash_attention", fwd, ("flash_attention.cu",
                                      "src/repro/kernels/flash_attention.py:100")),
            ("flash_attention_bwd", bwd, ("flash_attention_bwd.cu",
                                          "src/repro/models/layers.py:154"))):
        by_name[kernel]["max_abs_err"] = max(by_name[kernel]["max_abs_err"],
                                             timed["max_abs_err"])
        rows.append({"name": f"{kernel} ({name}, [74]'s training jobs)", "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{source[0]}",
                     "replaces": source[1],
                     "launches": sum(got[kernel] for got in launches.values()), **timed})
    # K4's log-sum-exp instance at a (2, 2) serving rank's slice, f32: B 2,
    # (1,024 + 2) / 2 slots, rank 0's slice (every slot valid)
    batch, prompt = next(j[5:7] for j in SV_F32_JOBS if j[0] == like)
    b, slots = batch // shape[0], (prompt + gen) // shape[1]
    g = torch.Generator(device=DEV).manual_seed(SEED + 74)
    q = torch.randn(b, 40, 128, generator=g, device=DEV)
    kc, vc = (torch.randn(b, 8, slots, 128, generator=g, device=DEV) for _ in range(2))
    kpos = cache_slot_positions(prompt + 1, prompt + gen, False, DEV)[:slots].contiguous()
    timed = k4_lse_timing(q, kc, vc, kpos, prompt, f"rank slice of FSDP {shape}")
    k4 = by_name["flash_decode"]
    k4["max_abs_err"] = max(k4["max_abs_err"], timed["max_abs_err"])
    rows.append({"name": f"flash_decode return_lse (Qwen2.5-14B f32 serving, FSDP {shape} "
                         "rank slice)", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
                 "replaces": "src/repro/kernels/flash_decode.py:88",
                 "launches": r0["launches"]["flash_decode_lse"],
                 "launches_per_step": r0["launches"]["flash_decode_lse"] // gen, **timed})
    check(all(r["launches"] > 0 for r in rows), "[74]: a kernel was not launched on the main "
          "path at a rank's shape")
    sv_s = max(r["s"] for r in runs)
    print(f"  [74] took {lay['s'] + sv_s + time.perf_counter() - t0:.1f} s ({lay['s']:.1f} s "
          f"of it its training jobs within [64]'s spawn, {sv_s:.1f} s its serving job within "
          f"[67]'s)")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32: off for matmuls and cuDNN (full float32 everywhere)")
    built = _build.build()
    print(f"[1] kernels built in {built.seconds:.1f} s into {built.directory}")
    for name, log in built.logs.items():
        for line in log.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "error")):
                print(f"    {name}: {line.strip()}")

    rng = np.random.default_rng(SEED)
    print("[2] K1 union_segsum vs plain version")
    err_k1 = phase_k1(rng)
    print("[3] K2 rowsparse_scatter vs plain version")
    err_k2 = phase_k2(rng)

    print("[4] main path: LR FedSubAvg at MovieLens-1M width")
    t0 = time.perf_counter()
    ds = make_movielens_like(num_clients=N_CLIENTS, num_items=3706,
                             mean_samples=165, seed=SEED)
    print(f"  data: {ds.stats()} V={ds.num_features} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(ds.num_features == 37_069, "V must be 37,069")
    lr_ds = ds
    runs, launches_k1, captured = phase_main_path(ds)
    lr_runs = runs
    k1_args = captured["args"]
    launches_k2, err_k2_path = phase_k2_path(k1_args)

    print("[5] card vs host, 5 rounds")
    phase_card_vs_host(ds)

    print("[6] kernel times")
    kernels = phase_timing(k1_args, launches_k1, launches_k2, err_k1,
                           max(err_k2, err_k2_path), rng)

    print("[7] where a fedsubavg round's time goes")
    phase_profile(ds, runs["fedsubavg"]["steady_ms_per_round"])

    print("[8] K3 flash_attention vs plain version")
    err_k3 = phase_k3(rng)
    print("[9] K4 flash_decode vs plain version")
    err_k4 = phase_k4(rng)
    print(f"[10] serving path: {SERVE_ARCH} at its published size")
    served, params, captured = phase_serve()
    print("[11] card vs host, 2 layers at full width, f32")
    phase_serve_card_vs_host()
    print("[12] K3 and K4 times at the serving path's inputs")
    kernels += attention_timing(captured, served["launches"], err_k3, err_k4)
    print("[13] where a decode step's time goes")
    phase_decode_profile(params, served["decode_ms_per_token"])
    print("[14] where a prefill's time goes")
    phase_prefill_profile(params, served["prefill_ms"])
    del params, captured

    deep = {}
    for n, make, kw, title, reduced in (
            (15, make_amazon_like, DIN_DATA, "DIN FedSubAvg at Amazon Electronics' "
             "63,001 goods (D = 18)", DIN_REDUCED),
            (16, make_sent140_like, LSTM_DATA, "LSTM FedSubAvg on Sent140-like data "
             "(D = 25)", LSTM_REDUCED)):
        print(f"[{n}] {title}")
        t0 = time.perf_counter()
        ds = make(**kw)
        print(f"  data: {ds.stats()} V={ds.num_features} "
              f"({time.perf_counter() - t0:.1f} s to generate)")
        print(f"  reduced: {reduced}")
        deep[ds.task] = (ds,) + phase_deep_path(ds)
        print(f"  [{n}] took {time.perf_counter() - t0:.1f} s")
    check(deep["din"][0].num_features == 63_001, "DIN's V must be 63,001")

    print("[17] card vs host, DIN and LSTM, 200 clients, 3 rounds")
    t0 = time.perf_counter()
    for make, kw in ((make_amazon_like, DIN_DATA), (make_sent140_like, LSTM_DATA)):
        phase_card_vs_host(make(**{**kw, "num_clients": 200}), rounds=3)
    print(f"  [17] took {time.perf_counter() - t0:.1f} s")

    print("[18] where a DIN and an LSTM fedsubavg round's time goes; K1 at their rounds")
    t0 = time.perf_counter()
    k1 = kernels[0]
    check(k1["name"] == "union_segsum", "the first kernel entry is K1's")
    k1["launches_by_path"] = {"lr": launches_k1}
    for task, (ds, runs, launches, cap, err) in deep.items():
        prof = phase_profile(ds, runs["fedsubavg"]["steady_ms_per_round"],
                             n=2 if task == "lstm" else 3)
        timed = time_k1_k2(cap["args"], cap["kw"]["scale"], f"{task} round", keys=("k1",),
                           profiled={"k1": (prof["k1_device_ops_per_round"],
                                            prof["k1_device_ms_per_round"])})
        k1[f"{task}_round"] = {"shape": timed["shape"], **timed["k1"]}
        k1["launches_by_path"][task] = launches
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
    print(f"  [18] took {time.perf_counter() - t0:.1f} s")

    print("[19] Table 2's algorithms at MovieLens-1M width: scaffold and fedadam "
          "(sparse and dense), dense fedsubavg, central SGD")
    t0 = time.perf_counter()
    _, protocol_launches, err = phase_protocol_paths(lr_ds)
    for label in ("scaffold sparse", "fedadam sparse"):
        k1["launches_by_path"]["lr " + label] = protocol_launches[label]
    k1["max_abs_err"] = max(k1["max_abs_err"], err)
    print(f"  [19] took {time.perf_counter() - t0:.1f} s")

    print("[20] private and weighted heat at MovieLens-1M width, fedsubavg sparse")
    t0 = time.perf_counter()
    phase_private_heat(lr_ds)
    print(f"  [20] took {time.perf_counter() - t0:.1f} s")

    print("[21] card vs host, 200 clients, 3 rounds: scaffold and fedadam sparse, "
          "fedsubavg dense, central, randomized-response fedsubavg")
    t0 = time.perf_counter()
    small = make_movielens_like(num_clients=200, num_items=3706, mean_samples=165,
                                seed=SEED)
    phase_card_vs_host(small, rounds=3, cases=(
        ("scaffold sparse", "scaffold", dict(server_lr=1.0)),
        ("fedadam sparse", "fedadam", dict(server_lr=0.03)),
        ("fedsubavg dense", "fedsubavg", dict(sparse=False)),
        ("central", "central", dict(sparse=False)),
        ("fedsubavg randomized response", "fedsubavg",
         dict(heat_estimator="randomized_response"))))
    print(f"  [21] took {time.perf_counter() - t0:.1f} s")

    print("[22] Table 2 and Table 3 through the port (tools/paper_tables.py)")
    t0 = time.perf_counter()
    for sparse in (False, True):
        out = tables(sparse=sparse, device=DEV)
        check(all(math.isfinite(r["best"]) for r in out["table2"] + out["table3"]),
              "a table's best loss is not finite")
        print_tables(out, sparse, card)
    print(f"  [22] took {time.perf_counter() - t0:.1f} s")

    print("[23] ReplicatedLocal x RowSparseTransport through the trainer at MovieLens-1M "
          "width")
    t0 = time.perf_counter()
    rep_runs, rep_launches, err = phase_replicated(lr_ds, lr_runs)
    for alg, n in rep_launches.items():
        k1["launches_by_path"][f"lr replicated {alg}"] = n
    k1["max_abs_err"] = max(k1["max_abs_err"], err)
    print(f"  [23] took {time.perf_counter() - t0:.1f} s")

    print("[24] int8 rows through the trainer at MovieLens-1M width")
    t0 = time.perf_counter()
    f32_runs = {"f32": lr_runs["fedsubavg"], "f32 top-16": lr_runs["fedsubavg_top16"],
                "f32 replicated": rep_runs["fedsubavg"]}
    f32_runs["f32 top-16 replicated"] = drive(
        make_trainer(lr_ds, "fedsubavg", DEV, sparse_topk=16, sparse_local="replicated"),
        "f32 top-16 replicated")
    _, int8_launches = phase_int8(lr_ds, f32_runs, rng)
    for label, n in int8_launches.items():
        k1["launches_by_path"][f"lr {label}"] = n
    print(f"  [24] took {time.perf_counter() - t0:.1f} s")

    print("[25] make_round_step on the LSTM at [16]'s width: four modes, microbatches, "
          "int8, debug checks, gather before backward at V = 2^22")
    t0 = time.perf_counter()
    steps = phase_round_steps(deep["lstm"][0])
    for label in ("sparse_replicated", "int8 sparse_replicated"):
        k1["launches_by_path"][f"lstm make_round_step {label}"] = steps["launches"][label]
    k1["max_abs_err"] = max(k1["max_abs_err"], steps["k1_err"])
    print(f"  [25] took {time.perf_counter() - t0:.1f} s")

    print("[26] card vs host, 200 clients, 3 rounds: replicated, int8, make_round_step; "
          "Example 1")
    t0 = time.perf_counter()
    phase_new_card_vs_host(small, make_sent140_like(**{**LSTM_DATA, "num_clients": 200}))
    print(f"  [26] took {time.perf_counter() - t0:.1f} s")

    print("[27] round telemetry at MovieLens-1M width: on against off, the JSONL sink, "
          "first dispatches, the LSTM step bit for bit, a planted capacity")
    t0 = time.perf_counter()
    tel = phase_telemetry(lr_ds, deep["lstm"][0])
    for label, n in tel["launches"].items():
        k1["launches_by_path"][f"lr {label}"] = n
    print(f"  [27] took {time.perf_counter() - t0:.1f} s")

    print("[28] run(profile_dir=...): the trace, its round ranges and K1's events")
    t0 = time.perf_counter()
    phase_profile_dir(lr_ds)
    print(f"  [28] took {time.perf_counter() - t0:.1f} s")

    print("[29] the buffered-async engine at MovieLens-1M width")
    t0 = time.perf_counter()
    asyn = phase_async(lr_ds, tel["off"]["ms_per_round"])
    for label, n in asyn["launches"].items():
        k1["launches_by_path"][f"lr async {label}"] = n
    k1["async_fire"] = asyn["k1"]
    k1["max_abs_err"] = max(k1["max_abs_err"], asyn["k1"]["max_abs_err"])
    print(f"  [29] took {time.perf_counter() - t0:.1f} s")

    print("[30] card vs host: the async engine on 200 clients, K = 20, 6 waves; a mid-run "
          "checkpoint saved on the card and resumed on the host")
    t0 = time.perf_counter()
    phase_async_card_vs_host(small)
    print(f"  [30] took {time.perf_counter() - t0:.1f} s")

    print("[31] LR through FederatedTrainer(mesh=...) at MovieLens-1M width: 1 rank "
          "(NCCL), 2 and 4 ranks (gloo) on the one card")
    t0 = time.perf_counter()
    plain, mesh_ranks = phase_mesh_runs(lr_ds, deep["din"][0], deep["lstm"][0])
    mesh_lr = phase_mesh_lr(plain, mesh_ranks)
    for label, per_rank in mesh_lr["launches"].items():
        k1["launches_by_path"][f"lr mesh {label}"] = per_rank
    for (args, kw), tag in zip(mesh_lr["k1_calls"], ("mesh_partial", "mesh_union")):
        args = tuple(a.to(DEV) if torch.is_tensor(a) else a for a in args)
        ids, rows, v = args[0], args[1], args[5]
        union = int(torch.unique(ids[(ids >= 0) & (ids < v)]).numel())
        k1["max_abs_err"] = max(k1["max_abs_err"],
                                check_k1(f"union_segsum[{tag}]", args, kw["scale"], union))
        timed = time_k1_k2(args, kw["scale"], f"LR x2 union, {tag}", keys=("k1",),
                           profile=False)
        k1[tag] = {"shape": timed["shape"], **{f: timed["k1"][f] for f in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}
    print(f"  [31] took {time.perf_counter() - t0:.1f} s (with [32] and [33]'s runs)")

    print("[32] DIN through FederatedTrainer(mesh=...), 2 ranks: the union combine")
    k1["launches_by_path"]["din mesh x2 fedsubavg union"] = phase_mesh_din(
        plain, mesh_ranks[2])

    print("[33] make_round_step on the mesh, 2 ranks, on the LSTM's inputs: four modes, a "
          "cohort that does not divide, debug checks; collectives against the budget")
    step_launches, mesh_drift = phase_mesh_steps(mesh_ranks[2])
    for label, per_rank in step_launches.items():
        k1["launches_by_path"][f"lstm mesh x2 make_round_step {label}"] = per_rank
    del plain, mesh_ranks

    kernels += phase_lm_training(kernels, rng, k1)
    kernels += phase_moe_slice(kernels, rng)
    kernels += phase_vlm_slice(kernels, rng)
    kernels += phase_rec_slice(kernels, rng)
    kernels += phase_whisper_slice(kernels, rng)
    phase_checking_planes(kernels, lr_ds, deep["din"][0], deep["lstm"][0], mesh_drift)
    fam_train = fam_train_prepare()
    tp_rows, sparse, tp_world, layouts = phase_tp_slice(kernels, rng, fam_train["spawn"])
    kernels += tp_rows
    fam_serve = fam_serve_prepare()
    try:
        sv_rows, sv_world = phase_serve_tp_slice(kernels, rng, fam_serve["spawn"])
    finally:
        for ref in fam_serve["refs"]:
            Path(ref["path"]).unlink(missing_ok=True)
    kernels += sv_rows
    kernels += phase_sparse_tp(kernels, sparse)
    fam_launches = phase_fam_train(fam_train, tp_world)
    fam_launches.update(phase_fam_serve(fam_serve, sv_world))
    kernels += phase_fam_kernels(kernels, fam_launches)
    kernels += phase_layouts(kernels, layouts, sv_world)
    print(f"done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
