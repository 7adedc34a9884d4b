"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

It drives the port's two serving paths, the paged engine on the Hopper
paged attention kernels and the dense fused engine (the serve driver's
default) on the flash attention and split-K decode kernels, the dense
engine on the Mamba-1 family on the fused selective-scan kernel, the
paper's
MARGOT pipeline (batch and stream) on the pair-score kernel, and the
paper's service architecture (``MLaaSService`` -> ``Router`` -> thread
and process replicas of the engines and of the stream), and the paged
engine's KV lifecycle (speculative decode verified by the paged extend
kernel, copy-on-write forks, KV swap, export/import, brownout and a
migrating drain behind the Router), starcoder2-3b (LayerNorm, a GELU MLP,
24 query heads over 2 kv heads: G 12), internvl2-1b's decoder (G 7, hd 64)
and the MoE family (qwen3-moe-30b-a3b: 128 experts top-8, qk-norm, G 8)
on both attention paths, gemma-7b (head dim 256, MHA, GeGLU) on both and
gemma3-4b (head dim 256, local layers over rings of their window, global
layers, qk-norm) on the dense one, recurrentgemma-2b (RG-LRU layers, their
recurrence on the scan kernel at N = 1, and MQA local attention at G 10,
hd 256) on the dense one, deepseek-v2-lite-16b (MLA: its prefill on
flash at q/k 192 and v 128, its absorbed decode on the MLA decode kernel;
a dense first layer; shared experts) on the dense one, the telemetry
(time series, SLO engine, stats server, autoscaler) over process
replicas, and training (internlm2-1.8b at full width taking AdamW steps
through ``launch/train.py``, its attention on the flash forward and the
flash backward kernel, a checkpoint resumed), whisper-base (the
encoder-decoder family: a serve through the prefill and decode steps and
AdamW steps through the train step at full width, its cross attention on
flash at a kv length of its own, forward and backward), the
multi-device paths on 2 ranks sharing the card over gloo (the sharded
MARGOT step, elastic re-placement, the compressed all-reduce,
data-parallel training, the sequence-sharded prefill on flash at a query
offset), and holds every kernel against its plain PyTorch version.  Each
phase ends on a line of its own with its wall time
(``[smoke] phase N wall``).  The phases:

1. device: the card's name and power limit (``nvidia-smi``), then the
   build of ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc``, one
   process per source, all started together (timed), and ptxas's
   registers and spills for the two wgmma attention kernels, the fp32
   flash and extend kernels on the CUDA cores, the split-key decode
   kernel of both decode sources (each at hd 16-256), the pair
   score's 3xTF32 wgmma kernel, the three scan kernels (the single
   walk, the chunked scan, the fused selective scan) and the MLA decode
   (bf16 and fp32 at rank 512 / rope 64, fp32 at 32 / 8), with flash's
   instantiations at (q/k, v) (192, 128) (wgmma and fp32) and (24, 16)
   (fp32); a spill fails the run;
2. kernels against their plain versions (``repro_torch.kernels.ref``) at
   the main paths' shapes in bf16 (H=16, KV=8, hd=128; paged: bs=16,
   ragged lengths up to 2048, an extend of S=256 at pos0 > 0; dense: a
   causal flash prefill of B=3, S=512, a decode of B=8 over L=2048 at
   ragged lengths), plus a small grid over every head_dim and dtype the
   kernels are built for (and flash's three mask modes, and a decode row
   of length 0), and the wgmma kernels' tile edges (flash at S 63, 64,
   65, 129, 200 and G 1, 4, 8, 12; the extend at bs 8 and 16 with pages
   straddled and a row past the table; a long-prefix extend of 2,048
   keys; an extend whose unseen pool rows hold NaN), and the split-key
   decode's edges in fp32 and bf16 (lengths around one and two
   128-key chunks, pages of 8, 16, 32, 12 and 128 rows, G 1 to 16, a
   length past the table and table entries past the pool, rows of length
   0, caches whose rows past every live key hold NaN), each
   held against the plain version's fp32 result on the
   same inputs, with a control (P rounded to bf16) that the bf16 limit
   must reject; flash also at (1, 2048), above the bf16 ridge; both
   decodes also at the serves' shape (B=8, lengths 301-329) and at a tiny
   one (B=1, length 8), with the host's issue time; the pair
   score at the batch shape (256, 512, 1024) and the stream's (1024,
   1024, 1024) on MARGOT features and on random inputs, on the 3xTF32
   wgmma route, and on a small grid in fp32 and bf16 over both routes
   (wgmma: fp32 with d % 4 == 0, with its edges: N and M off its tiles, a
   ragged last depth chunk, d off its 32-deep stages; the CUDA cores: bf16
   or d % 4 != 0), each held against the plain version in fp64 and
   repeated for bit-identical scores, with a TF32 control that the limit
   must reject; the scan kernel at the Mamba serve's admit shapes (4,
   512, 8192, 16), (1, 1000, 8192, 16), (2, 256, 8192, 16), (1, 100, 8192,
   16) (the single walk; phase 4 checks that the serve admits exactly
   these) and on a small grid (N 8 and 16, S 1 and ragged, an odd D N and
   a misaligned view: the chunked scan), each held against the plain
   version at atol = rtol = 1e-4, with a control (the carry zeroed at
   every 64-step chunk) that the limit must reject; kernel, plain and
   library times and the bound; the fused selective scan
   (``ops.ssm_scan``) on the CPU tests' grid (N 3, 8, 16 x S 1, 37, 130,
   with and without h0, B and C as strided views) and at the Mamba admit
   shapes, held against ``ref.selective_scan_ref`` at the same tolerance
   with a control (the carry zeroed every 32 steps), its exponential's
   error, the peak memory of a call, kernel, plain and replaced-route
   times and the bound (bytes or exponentials); and the paged extend
   at the speculative verify's shape (B 8, S 4, pos0 301-329 not
   block-aligned and one window past a 512-key table), with the bf16
   rule and its control, kernel, plain and SDPA times and the bound; then
   the four attention kernels again at the main paths' shapes and lengths
   with starcoder2-3b's heads (H 24, KV 2, G 12), qwen3-moe-30b-a3b's (H
   32, KV 4, G 8) and internvl2-1b's (H 14, KV 2, G 7, hd 64), each with
   the bf16 rule, its control, its times, bound and SDPA's time; last,
   after every check above (so their inputs stay those of earlier runs),
   hd 256: the grid in fp32 and bf16, the wgmma tile edges, the decode's
   edges at G 1, 2, 10 and 16, the four kernels at the main paths'
   shapes with gemma-7b's heads (H 16, KV 16, G 1) and gemma3-4b's (H 8,
   KV 4, G 2), flash at gemma3's window 1024 over S 2048, and flash and
   the extend at the admit shapes of the gemma serves, with the bf16
   rule, controls, times, bounds and SDPA; after those, recurrentgemma-2b:
   flash and the split-K decode at its heads (H 10, KV 1, G 10, hd 256)
   at the main paths' shapes, flash at its window 2048 over S 2,200 and
   at its serve's admit shapes, with the bf16 rule, controls, times,
   bounds and SDPA, and the scan kernel at N = 1 (the RG-LRU recurrence)
   at the split plan's edges (S 1, a chunk - 1, + 0, + 1 at the smallest
   and largest chunk, B 2, w % 4 != 0, a misaligned view) and at every
   admit length of its serve (B 1, w 2560) against the plain version, with
   the control's carry zeroed every chunk of the plan, timed at S 512 and
   2,200 beside its bound and the ``torch.cumsum`` yardstick; last,
   deepseek-v2-lite-16b: flash at q/k 192, v 128 (H 16, KV 16) at B 1 at
   each admit length of its phase-4 serve and at (3, 512) (timed, with
   SDPA), at the wgmma tile edges (S 63, 64, 65, 129, 200 x G 1, 2 x the
   three masks), and in fp32 at (192, 128) and (24, 16); the MLA decode at
   the serve's shape (B 8 over L 2048, lengths 301-329), at phase 2's
   ragged lengths and all 2048 keys, at B 1, length 1 (each timed, with
   its grid, S_MAX, MIN_KEYS and splits; beside SDPA over the latent kv
   head and SDPA with K/V expanded to 16 heads under each backend that
   takes q/k 576, v 512: the fastest is its library time), at its tile
   edges, a length past L and 0, with the rows past the live keys NaN,
   in bf16 and in fp32 at (512, 64) and (32, 8); flash and the split-K
   decode at hd 128, G 1 (the dense first layer); each bf16 check with
   its control (P rounded to bf16); after all of them the MLA decode at
   its split's edges (lengths 1, MIN_KEYS - 1, + 0, + 1, S_MAX MIN_KEYS -
   1, + 0, + 1 and 2048, at B 8 and at B 1), in bf16 with its control,
   with NaN rows, and in fp32 at both widths; last, the flash backward
   (``csrc/flash_attention_bwd.cu``) against autograd through the plain
   version in fp32 (each of dq, dk and dv within GRAD_REL of its own
   largest and of its mean plain magnitude, the forward's log-sum-exp
   within LSE_TOL, a second call
   bit for bit): at the training shape (B 4, S 1024, H 16, KV 8, hd 128,
   causal, bf16; timed beside its bound, the plain version's autograd
   and SDPA's flash backward, each as a captured ``torch.autograd.grad``),
   at S 1, 63, 64, 65, 129, 200, at G 1, 2, 8, 12, at hd 16, 32, 64, 256,
   at gemma3's window 1024 over S 2048, bidirectional with and without a
   window, in fp32 at every head dim, and its controls (a causal mask one
   key too wide; dq without the last key tile of the later rows; dk and
   dv without each 128-key tile's diagonal row tile) that the bf16 limit
   must reject; then S at the bf16 dK / dV kernel's key tile edges (127,
   128, 255, 256, 257 at hd 128; 63, 65, 127 at hd 256) and whole-query
   row tiles with rows left over (G 7 at hd 64, G 10 at hd 256; causal,
   a window, bidirectional); after all of those, whisper-base's shapes
   (H 8, KV 8, hd 64: G 1): flash over T 1,500 encoder states at the
   serve's cross shapes (B 8 x S 4, B 4 x S 224) and bidirectional at the
   encoder's (B 8 x S 1,500), each with the bf16 rule, its control, its
   times, bound and SDPA; flash at T != S at the tiles' edges (T 63, 64,
   65, 1,500, 1,501 x S 1, 63, 65 x G 1, 2, 8 x hd 64 and 128 in bf16,
   and a few in fp32); the split-K decode over the self cache (L 448,
   ragged lengths) and the cross cache (L 1,500, all live), timed; and the
   backward at a training step's three shapes (B 8: cross S 448 over T
   1,500, encoder S 1,500 bidirectional, decoder S 448 causal) within
   GRAD_REL, the cross one with a control (the last 128-key tile's keys
   dropped) that the bf16 limit must reject, each timed beside the plain
   version's autograd and SDPA's flash backward; last, flash at a query
   offset (T > S under a mask: the queries at the last S of T key
   positions) on a grid ((S, T) (63, 64), (65, 129), (64, 128), (130,
   195), (200, 900) x causal / window 48 / both x G 1, 2 x hd 64, 128 in
   fp32 and bf16, each bf16 check with its control), then at the
   sequence-sharded prefill's shapes: S 2,048 over T 4,096 causal at
   internlm2-1.8b's heads and gemma3-4b's local heads on a halo (window
   1,024, S 1,024 over T 2,048), with the bf16 rule, controls, times,
   bounds and SDPA (lower-right causal; the window's band as a mask);
3. token-exact: the two-layer fp32 reduced config served on the card by
   the paged and the dense engine, each through the kernels and forced
   through the plain versions; all four runs give the same tokens, and so
   does the paged engine with ``speculative=True`` (d=3) both ways, on
   the paged extend alone; then
   the two-layer fp32 reduced falcon-mamba-7b through the dense engine,
   through the kernel and forced through the plain version, with prompts
   of 130 and 100 tokens among them: both give the same tokens; and the
   two-layer fp32 reduced starcoder2-3b and internvl2-1b, paged and dense,
   kernel and plain, four times the same tokens; and the two-layer fp32
   reduced qwen3-moe-30b-a3b (8 experts, top-2), paged and dense, kernel
   and plain, the same tokens on each path (paged against dense is not a
   gate for MoE: a prefix hit's admit extends only the suffix, which
   changes the experts' capacity), every admit batch-1, then with
   ``speculative=True``: it falls back (``spec_fallback`` 1) and gives the
   paged tokens; and one MoE FFN call under CUDA's sync debug mode
   ``error`` (nothing reads back to the host); and at head dims 16 and
   256, the two-layer fp32 reduced gemma-7b, paged and dense, kernel and
   plain (four times the same tokens), and the ten-layer fp32 reduced
   gemma3-4b (window 16) dense, kernel and plain, with prompts past the
   window (flash's window mask, rings wrapped in prefill and decode);
   and the eight-layer fp32 reduced recurrentgemma-2b ((R, R, L) x 2 +
   (R, R), window 16, max_len 48) dense, kernel and plain, with prompts
   of 1, 2, 3 and past 16 tokens (flash 2, scan 6 a prefill batch), then
   asked for the paged engine: the same tokens, served dense, the
   fallback counted; and the three-layer fp32 reduced deepseek-v2-lite-16b
   (D x 1 + M x 2: MLA rank 32, rope 8, q/k 24, v 16, 2 shared experts)
   on the dense engine, kernel and plain, every admit batch-1, then asked
   for the paged engine and for speculative decode (both served dense,
   counted): the same tokens; and its MoE FFN with shared experts under
   sync debug ``error``; last, the fp32 reduced whisper-base (2 + 2
   layers, 100 frames, prompts of 5 tokens) greedy for 8 tokens through
   the prefill and decode steps, kernel and plain: the same tokens,
   logits within 1e-4;
4. full-width serves: internlm2-1.8b (24 layers, bf16, seeded random
   weights), 8 slots, max_len 2048, K=8, 8 requests of 16-512 tokens, two
   sharing a 256-token prefix, max_new 32, first paged (block_size 16),
   then dense; each path's kernel launch counts, read right after its own
   run, must be one a layer per admit batch (extend, flash) and per
   decode step (paged, split-K decode), with no plain calls; then one
   profiled decode sync of each.  Then starcoder2-3b the same two ways at
   full width (30 layers, d_model 3072, 24 heads over 2, d_ff 12288,
   LayerNorm, GELU MLP, tied, bf16, seeded random weights, 3.0 B
   parameters) and internvl2-1b's decoder (24 layers, d_model 896, 14
   heads over 2, hd 64, tied, vocab 151,655 padded to 151,680), their
   launch counts on each path and a profiled decode sync on the dense
   one.  Then, with
   those engines freed, falcon-mamba-7b (64 layers,
   d_model 4096, d_inner 8192, bf16, seeded random weights), 8 slots,
   max_len 2048, K=8, 8 requests (4 x 512, 1000, 2 x 256, 100 tokens,
   same lengths adjacent), max_new 32: ``ssm_scan`` launches (the fused
   kernel) must be 64 a prefill batch (256) with no plain calls; then one
   profiled decode sync and one profiled 4 x 512 admit on the fused kernel
   and one on the route it replaced (a_bar, b_bar, the scan kernel,
   einsum), each with its device memory before and at peak and the scan
   kernel its profile names.  Last, each engine alone on the card,
   qwen3-moe-30b-a3b at full width (48 layers, d_model 2048, 32 heads
   over 4, hd 128, 128 experts top-8, expert d_ff 768, qk-norm, vocab
   151,936, bf16, seeded random weights, 30.53 B parameters, no cut),
   paged then dense, as internlm2: parameter count, memory after the init
   and peak per serve, launch counts (48 a decode step and 48 an admit),
   every admit batch-1, tok/s and TTFT, and (paged only) a profiled decode
   sync with the expert products' device time beside the attention
   kernels'.
   Before the Mamba serve: gemma-7b (28 layers, d_model 3072, 16 heads
   MHA, hd 256, d_ff 24,576, GeGLU, vocab 256,000, tied, 8.54 B) paged
   and dense, and gemma3-4b (34 layers: 29 local with window 1024 over
   1,024-row rings, 5 global; 8 heads over 4, hd 256, d_ff 10,240,
   vocab 262,144, tied, 3.88 B) asked for the paged engine: it serves
   dense and counts the fallback, with a ninth request of 1,100 tokens
   past the window; each with its launch counts, tok/s, TTFT, memory
   after the init and at peak, and a profiled decode sync (gemma-7b's
   on the dense engine).  After
   gemma3-4b, recurrentgemma-2b (26 layers: 18 RG-LRU, 8 local over
   2,048-row rings at max_len 4096; 10 heads over 1, hd 256, d_ff 7,680,
   vocab 256,000, tied, 2.89 B, ``lambda`` fp32) asked for the paged
   engine: it serves dense and counts the fallback, with a ninth request
   of 2,200 tokens; launches exact (flash 8 and the scan 18 a prefill
   batch, the split-K decode 8 a step), a profiled decode sync and
   profiled 2,200-token admit with device time by kind (its scan must be
   the chunked kernel), and the gates of one layer alone.  Last, after
   qwen3's engines are freed, deepseek-v2-lite-16b alone (27 layers:
   kind D, then 26 MLA + MoE layers of 64 experts top-6 and 2 shared;
   bf16, seeded, 15.71 B, no cut) asked for the paged engine: it serves
   dense, counted; launches exact (flash 27 an admit, the split-K decode
   8 and the MLA decode 208 a sync), every admit batch-1, tok/s, TTFT,
   memory, and a profiled decode sync with the expert products', the
   absorption products' and the MLA decode's device time;
5. MARGOT at full size (d=1024, the paper's dataset sizes): DS1 through
   the kernel and through the plain version (equal link sets), the DS2
   batch through ``repro_torch.launch.argmining`` (its launch counts read
   right after it), DS1 with M3's 30,363 support vectors, the stream's
   rate ramp in both scopes, and one profiled batch partition;
6. cluster: (a) fp32 reduced internlm2-1.8b, dense then paged, through
   ``MLaaSService`` over a ``Router`` of 2 process replicas, token for
   token equal to an in-process engine on the same seeded weights;
   (b) internlm2-1.8b at full width (as phase 4; 16 requests of 16-512
   prompt tokens, 32 new tokens each) through the service, over 2 thread
   replicas sharing one copy of the weights (paged; the parent's kernel
   launch counts, reset just before), then over 2 process replicas
   (dense; spawn times, the engines' counters and kernel launches over
   the heartbeats), the same requests timed straight into the Router
   (tok/s, TTFT p50/p99), one replica SIGKILLed at the first token (every
   request completes exactly once, on the survivor), and the requests
   again on the survivor alone; (c) the MARGOT stream at phase 5's
   settings on 1 process replica, bit-identical to an in-process runtime
   on the same micro-batches, then on 2 replicas (every micro-batch
   acks); (d) the partition autotuner: ``measure_step`` of the MARGOT
   batch step at 3-48 documents a partition, the fitted cost model and
   ``choose_partition_size`` for a 0.25 s budget, beside the fixed 12;
   the build directory must be unchanged (the workers only load);
7. lifecycle: internlm2-1.8b at phase 4's width (paged, bs 16, 8 slots,
   max_len 2048, K=8, phase 4's 8 requests, max_new 32): (a) speculative
   decode (d=3): its tokens' agreement with phase 4's paged run (bf16, not
   a gate), the acceptance rate, tok/s and TTFT; the paged extend must
   launch 24 x (admit batches + 8 x syncs) times and nothing else;
   (b) a 300-token request forked 3 ways at its first token: each child's
   tokens equal the parent's, with COW copies; (c) KV swap on both tiers
   on an 80-block pool: every request completes once, ``kv_swap_out ==
   kv_swap_in > 0``, no pool exhaustion, each restore re-read bit for bit
   against the bytes swapped out; (d) engine A serves the two requests
   sharing the prefix and exports, engine B imports (its re-export equal
   to A's frame byte for byte) and serves a new prompt on that prefix
   from 16 cached blocks; (e) 2 thread replicas (paged, speculative)
   behind the Router: brownout L1 turns speculation off on both (the spec
   counters stop, every request completes) and a drain with
   ``migrate=True`` ships KV (sessions migrated, the survivor imported
   blocks);
8. telemetry: (a) internlm2-1.8b at full width (dense) on 1 process
   replica behind a least-loaded Router, with the serve driver's stats
   stack on its cluster snapshot (a ``TelemetrySampler`` every 0.25 s, an
   ``SLOEngine`` wired into ``router.slo``, a ``StatsServer`` on port 0)
   and an ``Autoscaler`` (1-3 replicas, its factory an ``engine_spec``)
   ticked every 0.25 s: a burst of 96 requests, one every 0.125 s, each
   completing exactly once; at least one scale-up while it lasts (each
   event printed with the seconds its tick took, the spawn), a scale-down
   once the pool is idle; tok/s before and after the first new replica is
   ready; the four routes fetched over HTTP and parsed, ``/metrics``
   carrying the workers' kernel launches; (b) the sampler's overhead: one
   engine, 16 requests with the stats stack off, on, on, off; (c)
   ``python -m repro_torch.launch.serve --stats-dump`` in a process of its
   own;
9. train: (a) the fp32 reduced internlm2-1.8b two layers deep (at head
   dim 64) takes 3 AdamW steps through the kernels and the same 3
   through the plain versions: losses, grad norms, parameters and
   moments agree within TRAIN_RTOL, every gradient finite and non-zero;
   (b) internlm2-1.8b at full width (bf16 parameters, fp32 moments,
   remat none) through ``launch/train.py``'s ``train``: B 4 x S 1024 from
   ``synthetic_tokens``, warmup 2, 8 steps with a ``Checkpointer`` in a
   temporary directory (each step's loss, grad norm, lr and ms; tokens/s,
   peak memory), exactly 24 x 8 flash forward and backward launches, one
   more step profiled (device time by kind), (d) the dry run of one more
   step (``launch/dryrun_lib.run_cell`` on fake tensors, a 1 x 1 mesh
   under broadcast; nothing allocated on the card) against that step on
   the card, once alone and once under ``dryrun_lib.counting``: FLOPs
   equal, each kernel's calls in the dry run (which launches nothing and
   leaves ``kernels.LAUNCHES`` at 0) equal to its launches on the card
   and to the counter's, the args equal to the inputs' bytes
   on the card, the temp bytes within DRY_TEMP_REL of each step's peak
   increase, the roofline terms and the step's share of the bf16 peak
   printed (over the step's host time and the profiled step's device
   busy time); then a run resumed from the step-4 checkpoint that must give
   step 5's loss bit for bit; (c) the selective scan on inputs that
   require grad raises;
10. whisper-base at full width (6 + 6 layers, d_model 512, 8 heads of 64,
   vocab 51,865 padded to 51,968, 97,318,912 parameters, seeded bf16
   weights, seeded fp32 stub frames of 1,500 rows): (a) the serve through
   ``steps.make_prefill_step`` / ``make_decode_step``: B 8 with Whisper's
   4-token start-of-transcript prompt, 64 greedy tokens, max_len 448,
   then B 4 with 224-token prompts, 32 tokens (encode, prefill and decode
   step ms, tok/s; exactly 18 flash launches a prefill and 12 split-K
   decode launches a step; every logit finite); the fp32 prefill on the
   card against the same weights' fp32 plain run on the CPU within
   WHISPER_FP32_ATOL, and the bf16 tokens' agreement with an fp32 kernel
   serve (not a gate); (b) the fp32 reduced family 3 AdamW steps kernel
   against plain within TRAIN_RTOL, then 6 AdamW steps at full width
   through ``steps.make_train_step`` (bf16 parameters, fp32 moments,
   remat none, B 8 x (1,500 frames, 448 tokens), warmup 2; loss, grad norm
   and ms a step, decoder tokens/s, peak memory, exactly 18 flash forward
   and 18 backward launches a step) and one more step profiled;
11. multi-device: first whisper-base's data-parallel steps on one rank
   here (the reference of (d)), then 2 ranks spawned on cuda:0 over gloo
   (``collectives.spawn``; NCCL refuses two ranks on one card), each
   asserting its device and its launches: (a) the sharded MARGOT step
   (``make_batch_step(PIPELINE, mesh)``) on DS1 and DS2, its gathered
   links against the shard-local oracle computed on the card with the
   plain version, a pair-score launch a step, beside the one-device
   step on the same rows; (b) ``ElasticRunner`` on those models, placed
   on 2 ranks, rescaled 2 -> 1 -> 2 over 12 documents of DS1 that drop
   nothing, the same links on each mesh; (c) ``compressed_psum`` of
   97,318,912 fp32 elements a rank within JAX's bound of the fp32
   all-reduce; (d) data parallelism: the fp32 reduced whisper-base, 3
   steps on 2 ranks against one rank within TRAIN_RTOL, then
   whisper-base at full width, 2 x B 4 of phase 10's B 8, 4 steps, each
   step's loss and grad norm against the one-rank run within
   MD_DP_LOSS_REL / MD_DP_GNORM_REL, the parameters bit-identical on
   both ranks after every step, 18 flash forward and 18 backward
   launches a step on each; (e) internlm2-1.8b at full width: rank 0's
   seeded weights placed by ``place_params`` (bytes, seconds), a B 1 x
   S 4,096 prefill under ``seqtp`` split 2 x 2,048 (24 flash launches a
   rank, rank 1's at S 2,048 over T 4,096) against rank 0's one-rank
   prefill: the same greedy token, logits and caches within MD_SEQ_REL;
   (f) the fp32 reduced gemma3-4b under ``seqtp`` (local layers on the
   halo, the global one gathered), kernel against plain and against the
   one-rank run within MD_FP32_TOL;
12. the ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.  With
``--kernels-only`` it runs phases 1 and 2 alone (the build and every
kernel check and time) and prints no result lines.  Without a card, or
outside a checkout of the repository, it exits non-zero and prints no
result.  The whole ``nvcc`` output goes to ``chiprun_out/``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# The card's peaks (HBM bytes/s, operations/s by type) and each kernel's
# work, from which every "bound ms" is computed, are those of
# src/repro_torch/kernels/work.py (``_work()``), which the dry run reads
# too.
# Tolerances.  Each kernel is held against its plain version run in fp32
# on the same inputs.  fp32: atol = rtol = 2e-5 (tests/test_kernels.py:16).
# bf16: the kernels keep scores and P in fp32, as the TPU kernels do, so
# the only loss is the final rounding to bf16 plus fp32 noise from another
# order of summation.  Hence every element lies within one bf16 unit in the
# last place (plus 1e-4 absolute) of the fp32 result, and at most 1% of
# the elements differ from that result rounded to bf16.  The control,
# the plain version with P rounded to bf16 before P.V as the model's
# plain mha does, must fail the 1% limit, or the check could not see that
# rounding.  Phase 2 prints both readings beside the limit: the share of
# the kernel's elements off the rounded fp32 result, and the control's.
FP32_TOL = 2e-5
BF16_ATOL = 1e-4
BF16_MISMATCH = 0.01
# the library call rounds P to bf16 itself; this looser check only shows
# that it computes the same function, so that its time is a fair yardstick
LIBRARY_TOL = 3e-2
# The pair score is held against its plain version run in fp64 on the same
# inputs: max |kernel - fp64| <= PAIR_REL * max |fp64|.  The fp32 route
# sums three TF32 products a term (3xTF32: hi and lo parts of both
# operands), the other route d fp32 products; both land at ~2e-7 to 9e-7
# of the largest score on an H100 (PERF.md, section 6).  TF32 keeps 10
# mantissa bits, so one TF32 product is off by up to 2^-11 and its scores
# by ~1e-4 of the largest, which the control (the plain version in fp32
# with TF32 on) shows by failing the limit at the batch and stream shapes.
PAIR_REL = 1e-5
# The selective scan is held against its plain version (fp32, one step at
# a time) at the repo's scan tolerance, atol = rtol = 1e-4
# (tests/test_kernels.py:199-200).  The kernel runs the same recurrence
# with one FMA a step, so only rounding separates them.  The control, the
# plain version with the carry zeroed at every 64-step chunk (what a
# chunked kernel that lost its carry would give), must fail the limit, or
# the check could not see the carry across chunks.
SCAN_TOL = 1e-4
SCAN_CHUNK = 64
# the partition autotuner's latency budget: the stream's period
# (configs/margot_svm.py, STREAM)
STREAM_BUDGET_S = 0.25
# The flash backward is held against autograd through the plain version in
# fp32 on the same inputs and the same upstream gradient: for each of dq,
# dk and dv alone, max |kernel - plain| <= GRAD_REL[dtype] times that
# gradient's largest plain magnitude, and mean |kernel - plain| <=
# GRAD_REL[dtype] times its mean plain magnitude (the mean reading sees
# an error spread over the many rows whose gradients are far below the
# largest, as a dq row that sees 500 keys is).  fp32: the same arithmetic
# in another order (the forward's FP32_TOL).  bf16: the kernels keep P
# and dS at fp32 accuracy (bf16 hi + lo into the tensor cores), but D =
# rowsum(dO * O) reads the forward's bf16-rounded O
# and each gradient is rounded to bf16 once (2^-9 relative), so 1%.  The
# controls must exceed the bf16 limit, or the check could not see what
# they move: the gradients of the plain version whose causal mask lets
# each query see one key more (in each of dq, dk and dv), and the plain dq
# with the last key tile of the second half of the rows left out (in both
# of its readings), and the plain dk and dv with each key tile's diagonal
# row tile left out (in both readings of each).  The forward's
# log-sum-exp (the backward's input) is held against torch.logsumexp of
# the masked scaled scores in fp32 at LSE_TOL
# absolute (fp32 sums of up to 2,048 terms, ex2.approx in the bf16 kernel).
GRAD_REL = {"float32": FP32_TOL, "bfloat16": 1e-2}
LSE_TOL = 1e-4


def fail(msg: str):
    print(f"[smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def main():
    kernels_only = sys.argv[1:] == ["--kernels-only"]
    if sys.argv[1:] and not kernels_only:
        fail(f"usage: python3 chip_smoke.py [--kernels-only]; got "
             f"{sys.argv[1:]}")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        fail("src/repro_torch not found beside chip_smoke.py: run it from "
             "the root of a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA "
             "card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = _walled(1, phase_device)
    stats = _walled(2, phase_kernels)
    if kernels_only:
        print("[smoke] --kernels-only: phases 1-2 passed; phases 3-12 and "
              "the result lines skipped")
        return
    _walled(3, phase_token_exact)
    launches, paged_tokens = _walled(4, phase_serve)
    launches.update(_walled(5, phase_margot))
    _walled(6, phase_cluster)
    _walled(7, phase_lifecycle, paged_tokens)
    _walled(8, phase_telemetry)
    launches.update(_walled(9, phase_train, smi))
    _walled(10, phase_whisper)
    _walled(11, phase_multidevice)
    _walled(12, phase_list, stats, launches, smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _walled(n, phase, *args):
    """Run phase ``n`` and print its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[smoke] phase {n} wall {time.perf_counter() - t0:.1f}s",
          flush=True)
    return out


# ----------------------------------------------------------------------
def phase_device() -> str:
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import pair_score as ps
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ssm_scan as ss
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} "
          f"count={torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    for module in (pa, fa, da, ps, ss, md):
        module._library()
    ss._fused_library()
    build_s = time.perf_counter() - t0
    usage = [ln.strip() for log in build.BUILD_LOG.values()
             for ln in log.splitlines() if "registers" in ln]
    line = (f"[build] {len(build.SOURCES)} source(s) in {build_s:.2f}s; "
            f"ptxas: {len(usage)} kernels, e.g. "
            f"{usage[-1] if usage else '-'}")
    print(line)
    for source, module, extra in (("flash_attention.cu", fa, ((192, 128),)),
                                  ("paged_attention.cu", pa, ())):
        smem = {dims: module._library().repro_attention_sm90_smem(*dims)
                for dims in ((128, 128), (256, 256)) + extra}
        print(f"[build] {source} "
              f"{_sm90_usage(build.BUILD_LOG, source, smem, extra)}")
    print(f"[build] {_simt_usage(build.BUILD_LOG)}")
    for source in ("paged_attention.cu", "decode_attention.cu"):
        print(f"[build] {source} {_decode_usage(build.BUILD_LOG, source)}")
    print(f"[build] pair_score.cu {_pair_usage(build.BUILD_LOG, ps)}")
    print(f"[build] {_scan_usage(build.BUILD_LOG)}")
    print(f"[build] mla_decode.cu {_mla_usage(build.BUILD_LOG, md)}")
    print(f"[build] flash_attention_bwd.cu "
          f"{_bwd_usage(build.BUILD_LOG, fa._bwd_library())}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text("\n".join(
        [smi, line] + [f"== {s}\n{log}" for s, log in
                       build.BUILD_LOG.items()]))
    return smi


# ----------------------------------------------------------------------
def _ptxas_reports(logs, source, kernel):
    """ptxas's report (stack, spills, registers, shared memory) of every
    instantiation of ``kernel`` in ``source``'s build, by its mangled
    template arguments; a spill, or no report for ``source``, fails the
    run.  ``logs`` is ``build.BUILD_LOG``, which holds the report kept
    beside a library built by an earlier process too."""
    check(source in logs, f"{source}: no nvcc report for its library")
    lines = logs[source].splitlines()
    found = {}
    for i, ln in enumerate(lines):
        args = re.search(kernel + r"I(\w+?)EEv", ln)
        if "Compiling entry function" in ln and args:
            info = " ".join(x.split("info    :")[-1].strip()
                            for x in lines[i + 2:i + 4])
            check("0 bytes spill stores, 0 bytes spill loads" in info,
                  f"{source}: {kernel}<{args[1]}> spills: {info}")
            found[args[1]] = info
    return found


def _dims(args):
    """The head dims in a kernel's mangled template arguments."""
    return tuple(int(x) for x in re.findall(r"Li(\d+)", args))


def _sm90_usage(logs, source, smem, extra=()) -> str:
    """The wgmma kernel of ``source`` at every head dim, and at the (q/k,
    v) pairs ``extra`` (each must have a report), shown at (128, 128),
    (256, 256) and ``extra`` beside ``smem[dims]``, the dynamic shared
    memory it asks for at launch (``Ring<hd, hd_v>::SMEM`` in
    csrc/attention_sm90.cuh)."""
    from repro_torch.kernels import HEAD_DIMS
    found = {_dims(k): v for k, v in
             _ptxas_reports(logs, source, "attention_sm90_kernel").items()}
    want = sorted([(hd, hd) for hd in HEAD_DIMS] + list(extra))
    check(sorted(found) == want,
          f"{source}: ptxas reported attention_sm90_kernel at (q/k, v) head "
          f"dims {sorted(found)}, not {want}")
    return "; ".join(f"attention_sm90_kernel<{d[0]}, {d[1]}>: {found[d]}; "
                     f"dynamic shared memory {smem[d]} bytes"
                     for d in smem) + f"; no spills at {want}"


def _simt_usage(logs) -> str:
    """The fp32 flash and extend kernels on the CUDA cores at every head
    dim (each must have a report and no spill), shown at hd 128 and 256
    (hd 256 takes 32 lanes a key and its 64 KiB merge buffer is dynamic
    shared memory, which ptxas does not count)."""
    from repro_torch.kernels import FLASH_QK_V_DIMS, HEAD_DIMS
    parts = []
    for source, kernel, extra in (
            ("flash_attention.cu", "flash_simt_kernel",
             sorted(FLASH_QK_V_DIMS)),
            ("paged_attention.cu", "paged_attention_kernel", [])):
        found = {}
        for k, v in _ptxas_reports(logs, source, kernel).items():
            d = _dims(k)
            found[d if len(d) == 2 and extra else (d[0], d[0])] = v
        want = sorted([(hd, hd) for hd in HEAD_DIMS] + extra)
        check(sorted(found) == want,
              f"{source}: ptxas reported {kernel} at head dims "
              f"{sorted(found)}, not {want}")
        parts += [f"{kernel}<{d[0]}, {d[1]}>: {found[d]}"
                  for d in [(128, 128), (256, 256)] + extra]
    return "; ".join(parts) + f"; no spills at hd {HEAD_DIMS} and (q/k, " \
        f"v) {sorted(FLASH_QK_V_DIMS)}"


def _bwd_usage(logs, lib) -> str:
    """The flash backward's tile kernels at every head dim: bf16 on the
    tensor cores (``flash_bwd_dkdv_sm90_kernel``,
    ``flash_bwd_dq_sm90_kernel``), fp32 on the CUDA cores
    (``flash_bwd_dkdv_kernel``, ``flash_bwd_dq_kernel``); each must have a
    report and no spill.  The bf16 dK / dV kernel moves
    registers between its warpgroups with setmaxnreg (128 x 40 + 256 x 232
    of a pool of 384 x 168), so ptxas must give it exactly 168 a thread: a
    smaller pool would leave its consumers waiting for registers forever,
    so the run stops before any launch.  Shown: registers at every head
    dim beside the dynamic shared memory each bf16 kernel asks for
    (``repro_flash_bwd_smem``), and whether ptxas serialised a wgmma."""
    from repro_torch.kernels import HEAD_DIMS
    source = "flash_attention_bwd.cu"
    parts = []
    for kernel, dn, which in (("flash_bwd_dkdv_sm90_kernel", "bf16", 0),
                              ("flash_bwd_dq_sm90_kernel", "bf16", 1),
                              ("flash_bwd_dkdv_kernel", "fp32", None),
                              ("flash_bwd_dq_kernel", "fp32", None)):
        found = {_dims(k)[0]: v for k, v in
                 _ptxas_reports(logs, source, kernel).items()}
        check(sorted(found) == sorted(HEAD_DIMS),
              f"{source}: ptxas reported {kernel} at hd {sorted(found)}, "
              f"not {sorted(HEAD_DIMS)}")
        regs = {hd: int(re.search(r"Used (\d+) registers", found[hd])[1])
                for hd in HEAD_DIMS}
        if kernel == "flash_bwd_dkdv_sm90_kernel":
            check(set(regs.values()) == {168},
                  f"{source}: {kernel} has {regs} registers a thread, not "
                  f"168 at every hd: its setmaxnreg split (128 x 40 + 256 x "
                  f"232) needs a pool of 384 x 168")
        smem = "" if which is None else ", smem " + "/".join(
            str(lib.repro_flash_bwd_smem(hd, which)) for hd in HEAD_DIMS)
        parts.append(f"{kernel} ({dn}) registers at hd {HEAD_DIMS}: "
                     f"{'/'.join(str(regs[hd]) for hd in HEAD_DIMS)}{smem}")
    serial = "wgmma.mma_async instructions are serialized" in logs[source]
    return "; ".join(parts) + f"; no spills; wgmma serialised by ptxas: " \
        f"{'yes' if serial else 'no'}"


def _mla_usage(logs, md) -> str:
    """The MLA decode kernels at each (dtype, r, rope) they are built for
    (each must have a report and no spill): bf16 on wgmma
    (``mla_decode_sm90_kernel``), fp32 on the CUDA cores
    (``mla_decode_kernel``), beside the dynamic shared memory each asks
    for."""
    from repro_torch.kernels import MLA_DIMS
    found = {}
    for kernel, dn in (("mla_decode_sm90_kernel", "bf16"),
                       ("mla_decode_kernel", "fp32")):
        for k, v in _ptxas_reports(logs, "mla_decode.cu", kernel).items():
            found[(dn,) + _dims(k)] = (kernel, v)
    want = sorted((str(t).split(".")[1].replace("bfloat16", "bf16")
                   .replace("float32", "fp32"),) + d
                  for d, ts in MLA_DIMS.items() for t in ts)
    check(sorted(found) == want, f"mla_decode.cu: ptxas reported the MLA "
          f"decode kernels for {sorted(found)}, not {want}")
    lib = md._library()
    return "; ".join(f"{found[k][0]}<{k[1]}, {k[2]}> ({k[0]}): "
                     f"{found[k][1]}; dynamic shared memory "
                     f"{lib.repro_mla_smem(int(k[0] == 'bf16'), k[1], k[2])} "
                     f"bytes" for k in want) + "; no spills"


def _decode_usage(logs, source) -> str:
    """The split-key decode kernel of ``source`` at every instantiation
    (fp32 and bf16, hd 16-256, 1-8 rows a CTA; each must have a report),
    shown at 2 rows a CTA (the main path's G) for each head dim, and at
    hd 256 for every row count (its 64 KiB ring is dynamic shared memory,
    which ptxas does not count)."""
    from repro_torch.kernels import HEAD_DIMS
    found = {}
    for k, info in _ptxas_reports(logs, source, "decode_sm90_kernel").items():
        m = re.match(r"(f|13__nv_bfloat16)Li(\d+)ELi(\d+)E", k)
        smem = re.search(r"(\d+) bytes smem", info)
        found[(m[1], int(m[2]), int(m[3]))] = (
            int(re.search(r"Used (\d+) registers", info)[1]),
            int(smem[1]) if smem else 0)
    want = {(t, hd, gr) for t in ("f", "13__nv_bfloat16")
            for hd in HEAD_DIMS for gr in (1, 2, 4, 8)}
    check(set(found) == want, f"{source}: ptxas reported decode_sm90_kernel "
          f"for {sorted(found)}, not every dtype x head dim x rows")
    show = "; ".join(
        f"{dn} " + ", ".join(f"hd {hd} {found[(t, hd, 2)][0]} registers "
                             f"{found[(t, hd, 2)][1]} B" for hd in
                             HEAD_DIMS)
        for t, dn in (("13__nv_bfloat16", "bf16"), ("f", "fp32")))
    wide = "; ".join(
        f"{dn} " + ", ".join(f"{gr} rows {found[(t, 256, gr)][0]}"
                             for gr in (1, 2, 4, 8))
        for t, dn in (("13__nv_bfloat16", "bf16"), ("f", "fp32")))
    most = max(r for r, _ in found.values())
    return (f"decode_sm90_kernel at 2 rows a CTA: {show} (static shared "
            f"memory); registers at hd 256 by rows a CTA: {wide}; up to "
            f"{most} registers at 8 rows; no spills in {len(found)} "
            f"instantiations")


def _pair_usage(logs, ps) -> str:
    """The pair score's wgmma kernel, both instantiations (projection and
    score; each must have a report and no spill), beside the dynamic
    shared memory it asks for, and ptxas's warnings that it serialised
    the kernel's wgmma, if any."""
    from repro_torch.kernels import pair_plan
    found = {re.match(r"Lb([01])", k)[1]: v for k, v in _ptxas_reports(
        logs, "pair_score.cu", "pair_sm90_kernel").items()}
    check(sorted(found) == ["0", "1"], f"pair_score.cu: ptxas reported "
          f"pair_sm90_kernel for {sorted(found)}, not both instantiations")
    serial = [ln.strip() for ln in logs["pair_score.cu"].splitlines()
              if "serialized" in ln]
    return (f"pair_sm90_kernel projection: {found['1']}; score: "
            f"{found['0']}; dynamic shared memory "
            f"{pair_plan.smem_bytes(ps._library())} bytes; wgmma "
            f"serialised: {serial[0] if serial else 'no'}")


def _scan_usage(logs) -> str:
    """ptxas's report of the scan kernels: the single walk at V = 4 and 1
    and the chunked scan with 16- and 4-byte staging (ssm_scan.cu), and
    the fused selective scan at each lane count (selective_scan.cu); each
    must have a report and no spill."""
    parts = []
    for source, kernels in (("ssm_scan.cu", ("ssm_scan_kernel",
                                             "ssm_scan_chunked_kernel")),
                            ("selective_scan.cu", ("ssm_scan_fused_kernel",))):
        check(source in logs, f"{source}: no nvcc report for its library")
        lines = logs[source].splitlines()
        for kernel in kernels:
            found = []
            for i, ln in enumerate(lines):
                m = re.search(r"Compiling entry function '(\w+)'", ln)
                if m and re.search(kernel + r"(I|E)", m[1]):
                    info = " ".join(x.split("info    :")[-1].strip()
                                    for x in lines[i + 2:i + 4])
                    check("0 bytes spill stores, 0 bytes spill loads" in
                          info, f"{source}: {kernel} spills: {info}")
                    found.append(re.search(r"Used (\d+) registers",
                                           info)[1])
            check(found, f"{source}: ptxas reported no {kernel}")
            parts.append(f"{kernel} {'/'.join(found)} registers")
    return "scan kernels: " + ", ".join(parts) + "; no spills"


#: the side stream every timing captures on (made at its first use)
_TIMING_STREAM = []


def _timing_stream():
    """One side stream for every capture of :func:`_time_ms`: PyTorch
    keeps a cuBLAS workspace for each stream cuBLAS runs on for the life of
    the process, so a new stream a timing left one behind each time (~1
    GiB allocated, and no tensor alive, by the end of phase 3)."""
    import torch
    if not _TIMING_STREAM:
        _TIMING_STREAM.append(torch.cuda.Stream())
    return _TIMING_STREAM[0]


def _time_ms(fns, iters: int = 20) -> float:
    """Device ms per call: ``iters`` calls cycling through ``fns`` (each on
    its own copy of the inputs, so the 50 MB L2 holds no earlier call's
    K/V, as on the main path where 24 layers take turns) are captured in
    one CUDA graph, and a replay of the graph is timed with CUDA events,
    so the host's time to issue each call is left out.  The warm-up calls
    run on the capturing stream, as PyTorch's graph warm-up does, so what
    a kernel keeps per stream (the decode's ticket counters) exists before
    the capture."""
    import torch
    stream = _timing_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for f in fns:
            f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def _issue_ms(fn, iters: int = 20, batches: int = 5) -> float:
    """Host ms per call of ``fn`` issued back to back from Python and
    timed with CUDA events, the median of ``batches`` batches of ``iters``
    calls (the host's time moves between batches): where the device is
    faster than the host, this is the host's cost to issue one call."""
    import statistics

    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(batches):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _paged_inputs(gen, B, nb, bs, KV, hd, q_shape, dtype, dev):
    import torch
    n_blocks = B * nb + 1
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev,  # noqa
                                 dtype=torch.float32).to(dtype)
    q = rnd(*q_shape)
    kp, vp = rnd(n_blocks, bs, KV, hd), rnd(n_blocks, bs, KV, hd)
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    bt = perm.reshape(B, nb).to(torch.int32).contiguous()
    return q, kp, vp, bt


def _sdpa_args(q, kp, vp, bt, keep):
    """SDPA inputs on the K/V gathered through the table (the gather is
    not timed): q (B,H,Sq,hd), k/v (B,KV,L,hd), bool mask (B,1,Sq,L)."""
    B, nb = bt.shape
    bs, KV, hd = kp.shape[1:]
    k = kp[bt.long()].reshape(B, nb * bs, KV, hd).transpose(1, 2)
    v = vp[bt.long()].reshape(B, nb * bs, KV, hd).transpose(1, 2)
    return q, k.contiguous(), v.contiguous(), keep


def _bf16_ulp(x):
    """bf16's unit in the last place at each value of ``x``."""
    import torch
    _, e = torch.frexp(x.abs().clamp_min(1e-30))
    return torch.ldexp(torch.ones_like(x), e - 8)


def _compare(name, out, want):
    """``out`` against ``want``, the plain version's fp32 result on the
    same inputs, at the tolerances above; returns (max_abs_err, share of
    bf16 elements that differ from ``want`` rounded to bf16)."""
    import torch
    check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite")
    err = (out.float() - want).abs()
    max_err = err.max().item()
    if out.dtype == torch.float32:
        check(torch.allclose(out, want, atol=FP32_TOL, rtol=FP32_TOL),
              f"{name}: max_abs_err {max_err:.3e} beyond atol=rtol="
              f"{FP32_TOL}")
        return max_err, 0.0
    share = (out != want.to(out.dtype)).float().mean().item()
    ulp_ok = bool((err <= _bf16_ulp(want) + BF16_ATOL).all())
    check(ulp_ok and share <= BF16_MISMATCH,
          f"{name}: max_abs_err {max_err:.3e}, {share:.4%} of elements off "
          f"the rounded fp32 result (limit {BF16_MISMATCH:.0%}), all within "
          f"one bf16 ulp + {BF16_ATOL}: {ulp_ok}")
    return max_err, share


def _rounded_p(q, k, v, keep):
    """The control: plain attention of q (B,S,H,hd) over k/v (B,L,KV,hd)
    where keep (B,S,L) allows, with P rounded to bf16 before P.V, as the
    model's plain mha does."""
    import torch
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd).float()
    sc = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    sc = sc.masked_fill(~keep[:, None, None], -2e38)
    p = torch.softmax(sc, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).reshape(
        B, S, H, v.shape[-1])


def _plain_rounded_p(q, kp, vp, bt, pos0):
    """The control of the paged extend (q (B,S,H,hd), queries at
    pos0 + s), on the K/V gathered through the table."""
    import torch
    B, S, H, hd = q.shape
    nb = bt.shape[1]
    bs, KV = kp.shape[1:3]
    k = kp[bt.long()].reshape(B, nb * bs, KV, hd)
    v = vp[bt.long()].reshape(B, nb * bs, KV, hd)
    qpos = pos0[:, None].long() + torch.arange(S, device=q.device)[None]
    keep = (torch.arange(nb * bs, device=q.device)[None, None, :] <=
            qpos[:, :, None])
    return _rounded_p(q, k, v, keep)


def _check_control(name, ctl, want):
    """The control ``ctl`` must differ from the rounded fp32 result in
    more than BF16_MISMATCH of its elements."""
    import torch
    ctl = ctl.reshape(want.shape)
    share = (ctl.to(torch.bfloat16) != want.to(torch.bfloat16)
             ).float().mean().item()
    check(share > BF16_MISMATCH,
          f"{name}: the bf16-P control differs in only {share:.4%} of "
          f"elements; the limit {BF16_MISMATCH:.0%} cannot see P rounding")
    return share


def _library_close(name, lib_out, want):
    import torch
    check(torch.allclose(lib_out.float(), want, atol=LIBRARY_TOL,
                         rtol=LIBRARY_TOL), f"{name}: the library call "
          f"computes another function (atol=rtol={LIBRARY_TOL})")


def _f32(*ts):
    return [t.float() for t in ts]


def phase_kernels():
    """Each kernel against its plain version, on the card."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    # every head_dim x dtype the kernels are built for, small shapes (hd
    # 256 in _hd256_checks, after every check of the smaller head dims, so
    # that their inputs stay the draws of earlier runs)
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (16, 32, 64, 128):
            n += _grid_case(gen, dtype, hd, dev)
    torch.cuda.synchronize()
    print(f"[kernels] grid: {n} checks over hd 16/32/64/128 x fp32 "
          f"(atol=rtol={FP32_TOL}) and bf16 (within one ulp + {BF16_ATOL}, "
          f"<= {BF16_MISMATCH:.0%} of elements off the rounded fp32 plain "
          f"result) passed: paged decode and extend; flash at S 37 and 192 "
          f"x causal / window 64 / bidirectional; split-K decode at "
          f"lengths 0, 1, 37, L")
    _attention_edges(gen, dev)
    _decode_edges(gen, dev)

    # main-path shapes, bf16; 3 copies of the inputs for cold-L2 timing
    stats, shares, issue = {}, {}, {}
    _paged_main_path(gen, dev, MAIN_HEADS, stats, shares, issue)
    _verify_shape(gen, dev)
    _dense_main_path(gen, dev, MAIN_HEADS, stats, shares, issue)
    _flash_long(gen, dev)
    for label, lengths, max_len in DECODE_SHAPES[1:]:
        for name, st in _decode_bench(gen, dev, lengths, max_len).items():
            print(f"[kernels] {name} at {label}: "
                  f"{_decode_row(st, lengths, max_len)}")
    _pair_score_checks(gen, dev, stats, issue)
    _ssm_scan_checks(gen, dev, stats, issue)
    # its own generator, so that the checks after it keep their inputs
    _fused_scan_checks(torch.Generator(device=dev).manual_seed(24), dev,
                       stats, issue)
    print(f"[kernels] bf16 tolerance: within one bf16 ulp + {BF16_ATOL} of "
          f"the plain version's fp32 result on the same inputs, and at most "
          f"{BF16_MISMATCH:.0%} of elements off that result rounded to bf16 "
          f"(the kernels keep P in fp32, so only fp32 summation order and "
          f"the output rounding separate them); control: the plain version "
          f"with P rounded to bf16 must exceed the {BF16_MISMATCH:.0%}")
    _print_main_path(stats, shares, issue, "")
    for arch, heads, hd in OTHER_HEADS:
        _other_heads(gen, dev, arch, heads, hd)
    for arch, heads, hd in (("internlm2-1.8b", MAIN_HEADS, 128),) + \
            OTHER_HEADS:
        _serve_admits(gen, dev, arch, heads, hd)
    _hd256_checks(gen, dev)
    _recurrentgemma_checks(gen, dev, stats)
    _deepseek_checks(gen, dev, stats)
    _mla_split_checks(gen, dev)
    # after every other check, on its own generator, so that theirs keep
    # their inputs
    _flash_bwd_checks(torch.Generator(device=dev).manual_seed(27), dev,
                      stats)
    # after every other check, on its own generator
    _whisper_kernel_checks(torch.Generator(device=dev).manual_seed(29), dev)
    # after every other check, on its own generator
    stats["flash_attention_offset"] = _offset_flash_checks(
        torch.Generator(device=dev).manual_seed(30), dev)
    return stats


def _grid_case(gen, dtype, hd, dev):
    """The small-shape checks at one head dim and dtype: the paged decode
    and extend (a row past the table's end), flash in its three mask
    modes and the split-K decode; returns the number of checks."""
    import torch
    from repro_torch.kernels import ops, ref
    dname = str(dtype).split(".")[1]
    B, H, KV, bs, nb, S = 3, 8, 2, 8, 6, 7
    q, kp, vp, bt = _paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd), dtype,
                                  dev)
    lengths = torch.tensor([1, 17, nb * bs], dtype=torch.int32, device=dev)
    _compare(f"decode hd={hd} {dname}",
             ops.paged_decode_attention(q, kp, vp, bt, lengths),
             ref.paged_decode_attention_ref(*_f32(q, kp, vp), bt, lengths))
    qs = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
    pos0 = torch.tensor([0, 9, nb * bs - 3], dtype=torch.int32,
                        device=dev)     # row 2 runs past the table
    _compare(f"extend hd={hd} {dname}",
             ops.paged_extend_attention(qs, kp, vp, bt, pos0),
             ref.paged_extend_attention_ref(*_f32(qs, kp, vp), bt, pos0))
    return 2 + _dense_grid(gen, dtype, dname, hd, dev)


#: (arch, (H, KV), hd) of the head-dim-256 serves of phase 4: gemma-7b (16
#: heads over 16, G 1: MHA) and gemma3-4b (8 over 4, G 2)
GEMMA_HEADS = (("gemma-7b", (16, 16), 256), ("gemma3-4b", (8, 4), 256))


def _hd256_checks(gen, dev):
    """Every kernel check of the smaller head dims at hd 256: the grid in
    fp32 and bf16, the wgmma tile edges, the split-key decode's edges at
    G 1, 2, 10 and 16 (and its clamped table, rows of length 0 and NaN
    rows); then the four attention kernels at the main paths' shapes and
    lengths with gemma-7b's and gemma3-4b's heads, flash at gemma3-4b's
    window 1024 over S 2048, and flash and the paged extend at the admit
    shapes of their phase-4 serves, each held to the bf16 rule with its
    control and timed beside its bound and SDPA."""
    import torch
    n = sum(_grid_case(gen, dtype, 256, dev)
            for dtype in (torch.float32, torch.bfloat16))
    torch.cuda.synchronize()
    print(f"[kernels] grid at hd 256: {n} checks over fp32 and bf16 passed "
          f"(the hd 16-128 grid's shapes and limits)")
    _attention_edges(gen, dev, hds=(256,), extras=False)
    _decode_edges(gen, dev, hds=(256,), heads=DECODE_EDGE_G_256,
                  extra_hd=256)
    for arch, heads, hd in GEMMA_HEADS:
        _other_heads(gen, dev, arch, heads, hd)
    _flash_window(gen, dev, "gemma3-4b", (8, 4), 256, 1024, 2048)
    for arch, heads, hd in GEMMA_HEADS:
        _serve_admits(gen, dev, arch, heads, hd)


#: recurrentgemma-2b's local attention: 10 query heads over 1 kv head (MQA,
#: G 10: the decodes' 8-row groups take 10 heads as 8 + 2) at hd 256
RG_HEADS = ("recurrentgemma-2b", (10, 1), 256)


def _recurrentgemma_checks(gen, dev, scan_stats):
    """After every earlier check, so that their inputs stay those of
    earlier runs: flash and the split-K decode at recurrentgemma-2b's
    heads at phase 2's main-path shapes; flash at its window 2048 over S
    2,200, the serve's long admit, and at the admit shapes of its phase-4
    serve; and the scan kernel at N = 1 at the serve's admit shapes, the
    RG-LRU recurrence."""
    arch, heads, hd = RG_HEADS
    stats, shares, issue = {}, {}, {}
    _dense_main_path(gen, dev, heads, stats, shares, issue, hd)
    H, KV = heads
    _print_main_path(stats, shares, issue,
                     f" at {arch}'s heads (H {H}, KV {KV}, G {H // KV}, "
                     f"hd {hd})")
    _flash_window(gen, dev, arch, heads, hd, _local_window(arch),
                  SERVE_LONG[arch])
    _serve_admits(gen, dev, arch, heads, hd)
    _linear_scan_checks(gen, dev, scan_stats)


#: deepseek-v2-lite-16b's attention: its dense first layer (kind D) at 16
#: heads over 16 (G 1) at hd 128, and its MLA layers: flash at q/k 192 (nope
#: 128 + rope 64) and v 128 over 16 heads, G 1, and the MLA decode over the
#: latent cache (rank 512, rope 64), all 16 heads on one latent kv head
DS_ARCH = "deepseek-v2-lite-16b"
DS_HEADS = (16, 16)
MLA_QK, MLA_V, MLA_R, MLA_RH = 192, 128, 512, 64
#: the MLA decode's edges: lengths one short of, at and one past one and
#: two key tiles (mla_decode.TILE_KEYS), 1, all of L (300 over L 300),
#: and 0 (the mean of ckv, as the plain version gives); the split's own
#: edges follow in _mla_split_checks
MLA_EDGE_LENGTHS = (63, 64, 65, 127, 128, 129, 1, 300, 0)


def _mla_inputs(gen, dev, B, L, dtype, H=16, r=MLA_R, rh=MLA_RH):
    return [_randn(gen, sh, dtype, dev) for sh in
            ((B, H, r), (B, H, rh), (B, L, r), (B, L, rh))]


def _mla_rounded_p(q_lat, q_rope, ckv, krope, lengths, scale):
    """The MLA decode's control: its plain version with P rounded to bf16
    before P ckv, as JAX's ``mla_decode`` rounds it (``p.astype(x.dtype)``,
    ``attention.py:641``)."""
    import torch
    s = (torch.einsum("bhr,blr->bhl", q_lat.float(), ckv.float()) +
         torch.einsum("bhd,bld->bhl", q_rope.float(), krope.float())) * scale
    ok = torch.arange(ckv.shape[1], device=ckv.device)[None, :] < \
        lengths[:, None].long()
    p = torch.softmax(s.masked_fill(~ok[:, None], -2e38), dim=-1)
    return torch.einsum("bhl,blr->bhr", p.to(torch.bfloat16).float(),
                        ckv.float())


def _mla_plan(B, L, lens, dev) -> str:
    """The MLA decode's grid and the splits its rows take."""
    from repro_torch.kernels import mla_decode as md
    s_max = md.split_plan(B, 16, MLA_R, L, md._sm_count(dev)).n_chunks
    runs = {n: md.splits(min(max(n, 0), L), s_max, md.MIN_KEYS)
            for n in sorted(set(lens))}
    shown = "; ".join(f"{n}: {len(r)} x {r[0][1] - r[0][0]}" + (
        f" .. {r[-1][1] - r[-1][0]}" if len(r) > 1 else "") for n, r in
        list(runs.items())[:4] if r)
    return (f"grid ({B}, {s_max}) in clusters of (1, {s_max}), S_MAX "
            f"{s_max}, MIN_KEYS {md.MIN_KEYS}, splits (length: count x "
            f"keys) {shown}")


def _mla_sdpa_backends(name, sd, keep, scale, want):
    """SDPA on the MLA decode's inputs with K/V expanded to the 16 query
    heads (copies made outside the timing), under each backend that
    ``torch.nn.attention.sdpa_kernel`` accepts for q/k 576, v 512 and a
    mask; returns (the fastest's ms, its name, the names that refused)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    ex = [(q, k.expand(-1, q.shape[1], -1, -1).contiguous(),
           v.expand(-1, q.shape[1], -1, -1).contiguous()) for q, k, v in sd]

    def call(x, backend):
        with sdpa_kernel(backend):
            return F.scaled_dot_product_attention(*x, attn_mask=keep,
                                                  scale=scale)
    times, refused = {}, []
    for backend in [getattr(SDPBackend, b) for b in (
            "FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
            "MATH") if hasattr(SDPBackend, b)]:
        try:
            out = call(ex[0], backend)
            torch.cuda.synchronize()
        except RuntimeError:
            refused.append(backend.name)
            continue
        _library_close(f"{name} SDPA {backend.name}", out[:, :, 0], want)
        times[backend.name] = _time_ms([lambda x=x, b=backend: call(x, b)
                                        for x in ex])
    check(times, f"{name}: every SDPA backend refused")
    best = min(times, key=times.get)
    del ex
    return times[best], best, refused


def _mla_split_checks(gen, dev):
    """After every other check of phase 2, so that theirs keep their
    inputs: the MLA decode at its split's edges, lengths 1, MIN_KEYS - 1,
    MIN_KEYS, MIN_KEYS + 1, S_MAX MIN_KEYS - 1, S_MAX MIN_KEYS, S_MAX
    MIN_KEYS + 1 and 2048, at B 8 over L 2048 (one row each) and at B 1
    (each alone), in bf16 with its control (P rounded to bf16) where a
    row holds more than one key, again with the rows past the live keys
    NaN, and in fp32 at (512, 64) and (32, 8)."""
    import torch
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import ops, ref
    bf, L, scale = torch.bfloat16, 2048, 1.0 / math.sqrt(MLA_QK)
    s_max = md.split_plan(8, 16, MLA_R, L, md._sm_count(dev)).n_chunks
    k = md.MIN_KEYS
    edges = [1, k - 1, k, k + 1, s_max * k - 1, s_max * k, s_max * k + 1, L]
    n = n_ctl = 0
    for batch in [edges] + [[e] for e in edges]:
        lengths = torch.tensor(batch, dtype=torch.int32, device=dev)
        B = len(batch)
        for dtype, r, rh, H in ((bf, MLA_R, MLA_RH, 16),
                                (torch.float32, MLA_R, MLA_RH, 16),
                                (torch.float32, 32, 8, 4)):
            for nan in (False, True):
                a = _mla_inputs(gen, dev, B, L, dtype, H, r, rh)
                want = ref.mla_decode_attention_ref(*_f32(*a), lengths,
                                                    scale)
                if nan:
                    for b, n_b in enumerate(batch):
                        if n_b < L:
                            a[2][b, n_b:] = float("nan")
                            a[3][b, n_b:] = float("nan")
                name = (f"mla_decode_attention split edge B {B} lengths "
                        f"{batch} {str(dtype)[6:]} ({r}, {rh})"
                        f"{' NaN rows' if nan else ''}")
                _compare(name, ops.mla_decode_attention(*a, lengths, scale),
                         want)
                n += 1
                if dtype == bf and not nan and max(batch) > 1:
                    _check_control(name, _mla_rounded_p(*a, lengths, scale),
                                   want)
                    n_ctl += 1
    torch.cuda.synchronize()
    print(f"[kernels] mla_decode_attention split edges: {n} checks passed "
          f"over L {L} at lengths {edges} (S_MAX {s_max} at B 8 and "
          f"{md.split_plan(1, 16, MLA_R, L, md._sm_count(dev)).n_chunks} at "
          f"B 1, MIN_KEYS {k}), B 8 and each length alone at B 1: bf16 "
          f"(512, 64) with {n_ctl} bf16-P controls rejected, fp32 (512, "
          f"64) and (32, 8) at atol=rtol={FP32_TOL}, each also with the "
          f"rows past the live keys NaN; {_mla_plan(8, L, edges, dev)}")


def _deepseek_checks(gen, dev, stats):
    """After every earlier check, so that their inputs stay those of
    earlier runs: flash at q/k 192, v 128 (G 1) at deepseek-v2-lite's
    prefill shapes (B 1 at each admit length of its phase-4 serve, and B
    3, S 512), at the wgmma tile edges and in fp32 at (192, 128) and (24,
    16); the MLA decode at the serve's shape (B 8 over L 2048 at lengths
    301-329), at B 8 over 2048 keys at phase 2's ragged lengths and all
    2048, at B 1, length 1, at its chunk edges, a length past L and 0,
    with rows past the live keys holding NaN, and in fp32 at (512, 64) and
    (32, 8); flash and the split-K decode at hd 128, G 1 (the dense first
    layer).  Each bf16 check held to the bf16 rule with its control (P
    rounded to bf16); the main shapes timed beside their bounds, the plain
    versions and SDPA (or, for the MLA decode, SDPA over its latent kv
    head)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import mla_decode as md
    from repro_torch.kernels import ops, ref
    bf, (H, KV) = torch.bfloat16, DS_HEADS
    at = f"(H {H}, KV {KV}, q/k {MLA_QK}, v {MLA_V})"

    # flash at (192, 128): the serve's admits, then B 3, S 512 timed
    errs, ctls = [], []
    admits = sorted({S for S, _ in _admit_shapes(DS_ARCH, False)})
    for S in admits:
        q = _randn(gen, (1, S, H, MLA_QK), bf, dev)
        k = _randn(gen, (1, S, KV, MLA_QK), bf, dev)
        v = _randn(gen, (1, S, KV, MLA_V), bf, dev)
        want = ref.flash_attention_ref(*_f32(q, k, v), causal=True)
        name = f"flash {DS_ARCH} admit {at} S={S}"
        errs.append(_compare(name, ops.flash_attention(q, k, v), want)[0])
        ctls.append(_check_control(
            name, _rounded_p(q, k, v, _window_keep(S, 0, dev)), want))
    print(f"[kernels] flash {at} at B 1, S {admits}, the admits of phase "
          f"4's {DS_ARCH} serve: max_abs_err={max(errs):.3e}, each within "
          f"the bf16 rule; the bf16-P controls off the rounded result in "
          f"{min(ctls):.4%} to {max(ctls):.4%} of elements, each rejected")
    B, S = 3, 512
    fsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, S, H, MLA_QK), (B, S, KV, MLA_QK), (B, S, KV, MLA_V))]
             for _ in range(3)]
    q, k, v = fsets[0]
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True)
    name = f"flash {at} (3, 512)"
    err, share = _compare(name, ops.flash_attention(q, k, v), want)
    ctl = _check_control(name, _rounded_p(
        q, k, v, _window_keep(S, 0, dev).expand(B, S, S)), want)
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in fsets]
    _library_close(name, F.scaled_dot_product_attention(
        *sd[0], is_causal=True).transpose(1, 2), want)
    st = _stats(
        err, _work().flash_attention(B, S, S, H, KV, MLA_QK, hd_v=MLA_V),
        _time_ms([lambda s=s: ops.flash_attention(*s) for s in fsets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s) for s in fsets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, is_causal=True) for a in sd]))
    print(f"[kernels] flash_attention {at} (3, 512) causal bf16: "
          f"max_abs_err={err:.3e} off_rounded={share:.4%} (control with "
          f"bf16 P: {ctl:.4%}) ms={st['ms']:.4f} plain_ms="
          f"{st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
          f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']}); device ms "
          f"from a CUDA graph replay")
    # the tile edges, at G 1 and G 2
    n = 0
    for S in FLASH_EDGE_S:
        for H_, KV_ in ((16, 16), (16, 8)):
            q = _randn(gen, (2, S, H_, MLA_QK), bf, dev)
            k = _randn(gen, (2, S, KV_, MLA_QK), bf, dev)
            v = _randn(gen, (2, S, KV_, MLA_V), bf, dev)
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                _compare(f"flash edge q/k {MLA_QK} v {MLA_V} S={S} G="
                         f"{H_ // KV_} causal={causal} window={window}",
                         ops.flash_attention(q, k, v, causal=causal,
                                             window=window),
                         ref.flash_attention_ref(*_f32(q, k, v),
                                                 causal=causal,
                                                 window=window))
                n += 1
    # fp32 on the CUDA cores at both pairs
    for dqk, dv in ((MLA_QK, MLA_V), (24, 16)):
        for S in (37, 192):
            q = _randn(gen, (2, S, 8, dqk), torch.float32, dev)
            k = _randn(gen, (2, S, 2, dqk), torch.float32, dev)
            v = _randn(gen, (2, S, 2, dv), torch.float32, dev)
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                _compare(f"flash fp32 q/k {dqk} v {dv} S={S} causal="
                         f"{causal} window={window}",
                         ops.flash_attention(q, k, v, causal=causal,
                                             window=window),
                         ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
                n += 1
    torch.cuda.synchronize()
    print(f"[kernels] flash with a narrower v: {n} checks passed: bf16 (q/k "
          f"{MLA_QK}, v {MLA_V}) at S {FLASH_EDGE_S} x G 1, 2 x causal / "
          f"window 64 / bidirectional; fp32 (atol=rtol={FP32_TOL}) at (192, "
          f"128) and (24, 16), S 37 and 192, the three masks")

    # the MLA decode: the serve's shape (timed), phase 2's ragged decode
    # and all 2048 keys, B 1 at length 1
    scale = 1.0 / math.sqrt(MLA_QK)
    L = 2048
    shapes = (("the serve's decode", list(range(301, 330, 4)), 8),
              ("phase 2's ragged decode",
               [2048, 1, 1537, 300, 16, 977, 2000, 64], 8),
              ("2048 keys a row", [2048] * 8, 8), ("B 1, length 1", [1], 1))
    for label, lens, B in shapes:
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        sets = [_mla_inputs(gen, dev, B, L, bf) for _ in range(3)]
        a = sets[0]
        want = ref.mla_decode_attention_ref(*_f32(*a), lengths, scale)
        name = f"mla_decode_attention at {label}"
        err, share = _compare(name, ops.mla_decode_attention(
            *a, lengths, scale), want)
        ctl = _check_control(name, _mla_rounded_p(*a, lengths, scale),
                             want) if B > 1 else float("nan")
        # SDPA over the latent kv head: q (B,H,1,r+rh), k (B,1,L,r+rh),
        # v (B,1,L,r), the live keys as a mask (built outside the timing)
        keep = (torch.arange(L, device=dev)[None, :] <
                lengths[:, None].long())[:, None, None]
        sd = [(torch.cat([s[0], s[1]], -1)[:, :, None],
               torch.cat([s[2], s[3]], -1)[:, None], s[2][:, None])
              for s in sets]
        lib = lambda x: F.scaled_dot_product_attention(  # noqa: E731
            *x, attn_mask=keep, scale=scale, enable_gqa=True)
        _library_close(name, lib(sd[0])[:, :, 0], want)
        gqa_ms = _time_ms([lambda x=x: lib(x) for x in sd])
        lib_ms, backend, refused = _mla_sdpa_backends(name, sd, keep, scale,
                                                      want)
        st = _stats(
            err, _work().mla_decode_attention(B, 16, MLA_R, MLA_RH, L,
                                              lengths=lens),
            _time_ms([lambda s=s: ops.mla_decode_attention(*s, lengths,
                                                           scale)
                      for s in sets]),
            _time_ms([lambda s=s: ref.mla_decode_attention_ref(
                *s, lengths, scale) for s in sets]), lib_ms)
        iss = _issue_ms(lambda: ops.mla_decode_attention(*a, lengths,
                                                         scale))
        print(f"[kernels] mla_decode_attention at {label} (B {B} over L "
              f"{L}, lengths {lens[:8]}, r {MLA_R}, rope {MLA_RH}, 16 heads) "
              f"bf16: max_abs_err={err:.3e} off_rounded={share:.4%} "
              f"(control with bf16 P: {ctl:.4%}) ms={st['ms']:.4f} "
              f"plain_ms={st['plain_ms']:.4f} library_ms={lib_ms:.4f} (SDPA, "
              f"K/V expanded to 16 heads, {backend} backend, the fastest "
              f"that takes q/k {MLA_R + MLA_RH}, v {MLA_R}; refused: "
              f"{', '.join(refused) or 'none'}; SDPA over the latent kv head "
              f"with enable_gqa {gqa_ms:.4f}) bound_ms={st['bound_ms']:.4f} "
              f"({st['bound_by']}); {_mla_plan(B, L, lens, dev)}; issued one "
              f"by one from Python: {iss:.4f} ms per call")
        if label == "the serve's decode":
            stats["mla_decode_attention"] = st
    # the edges: chunk boundaries, a length past L, 0; rows past the live
    # keys NaN; fp32 at (512, 64) and (32, 8)
    n = 0
    Le = 300
    lengths = torch.tensor(MLA_EDGE_LENGTHS, dtype=torch.int32, device=dev)
    B = len(MLA_EDGE_LENGTHS)
    for dtype, r, rh, H_ in ((bf, MLA_R, MLA_RH, 16),
                             (torch.float32, MLA_R, MLA_RH, 16),
                             (torch.float32, 32, 8, 4)):
        for nan in (False, True):
            a = _mla_inputs(gen, dev, B, Le, dtype, H_, r, rh)
            want = ref.mla_decode_attention_ref(*_f32(*a), lengths, scale)
            if nan:   # rows past each row's live keys (a row of length 0
                # sees none and averages all of them: it keeps its rows)
                for b, n_b in enumerate(MLA_EDGE_LENGTHS):
                    if 0 < n_b < Le:
                        a[2][b, n_b:] = float("nan")
                        a[3][b, n_b:] = float("nan")
            name = (f"mla_decode_attention edge {str(dtype)[6:]} ({r}, {rh}) "
                    f"H {H_}{' NaN rows' if nan else ''}")
            _compare(name, ops.mla_decode_attention(*a, lengths, scale),
                     want)
            if dtype == bf and not nan:
                _check_control(name, _mla_rounded_p(*a, lengths, scale),
                               want)
            n += 1
    torch.cuda.synchronize()
    print(f"[kernels] mla_decode_attention edges: {n} checks passed over L "
          f"{Le} at lengths {MLA_EDGE_LENGTHS} (key tiles of "
          f"{md.TILE_KEYS}; 300 is all of L; 0 the mean of ckv): bf16 "
          f"(512, 64) with its control, fp32 (512, 64) and (32, 8) at "
          f"atol=rtol={FP32_TOL}, each also with the rows past the live "
          f"keys NaN")

    # the dense first layer: flash and the split-K decode at hd 128, G 1
    st_, sh_, is_ = {}, {}, {}
    _dense_main_path(gen, dev, DS_HEADS, st_, sh_, is_, 128)
    _print_main_path(st_, sh_, is_, f" at {DS_ARCH}'s dense layer (H {H}, "
                                    f"KV {KV}, G 1, hd 128)")


#: the chunked scan's edges at N = 1, (B, S, w, misaligned): S 1, the
#: plan's smallest chunk - 1, the chunk, + 1 (single walk, single walk, two
#: chunks), its largest chunk - 1, the chunk and + 1 over 19 chunks
#: (ragged last chunks of 95 and 1 steps), B 2, w % 4 != 0 and a view
#: 4 bytes past a 16-byte boundary (the staging's 4-byte copies)
LINEAR_EDGES = ((1, 1, 2560, False), (1, 15, 2560, False),
                (1, 16, 2560, False), (1, 17, 2560, False),
                (1, 1823, 2560, False), (1, 1824, 2560, False),
                (1, 1825, 2560, False), (2, 600, 2560, False),
                (1, 300, 2559, False), (1, 300, 2560, True))


def _linear_scan_checks(gen, dev, stats):
    """The scan kernel at N = 1, as the RG-LRU recurrence runs it
    (``ops.linear_scan``: (B, S, w) viewed as (B, S, w, 1)): the plan's
    edges (LINEAR_EDGES), then every admit shape of phase 4's
    recurrentgemma-2b serve (B 1, w 2560), each against the plain version
    with the chunk-zeroed control at the plan's chunk; then kernel, plain
    and yardstick times and the bound at S 512 and 2,200 beside the single
    walk's earlier record on an H100 80GB HBM3 at 700 W."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref, scan_plan
    from repro_torch.kernels import ssm_scan as ss
    arch = RG_HEADS[0]
    w = get_config(arch).lru_width
    worst, ctls, plans = 0.0, [], []
    for B, S, width, misaligned in LINEAR_EDGES:
        a, b, h0 = _scan_inputs(gen, dev, B, S, width, 1)
        if misaligned:
            buf = torch.empty(a.numel() + 1, device=dev)
            buf[1:].copy_(a.reshape(-1))
            a = buf[1:].view(a.shape)
        plan = scan_plan.split_plan(B, S, width, 1)
        err, ctl = _scan_check(f"ssm_scan N=1 edge ({B}, {S}, {width})"
                               f"{' misaligned' if misaligned else ''}",
                               a, b, h0, control=plan.n_chunks > 1)
        worst = max(worst, err)
        ctls += [ctl] if ctl is not None else []
        plans.append((B, S, width) + tuple(plan[:2]))
    print(f"[kernels] ssm_scan N = 1 plan edges, (B, S, w, chunk, "
          f"n_chunks): {plans}, the last two on the one-channel threads (w "
          f"% 4 != 0; a view 4 bytes past a 16-byte boundary): max |kernel "
          f"- plain| {worst:.3e} (limit atol=rtol={SCAN_TOL}); the controls "
          f"(carry zeroed every chunk of the plan) off by {min(ctls):.3e} "
          f"to {max(ctls):.3e}, each rejected")
    lengths = sorted({S for S, _ in _admit_shapes(arch, False)})
    worst, ctls = 0.0, []
    for S in lengths:
        a, b, h0 = _scan_inputs(gen, dev, 1, S, w, 1)
        split = scan_plan.split_plan(1, S, w, 1).n_chunks > 1
        err, ctl = _scan_check(f"ssm_scan N=1 (1, {S}, {w})", a, b, h0,
                               control=split or S > SCAN_CHUNK)
        # the op the model calls: (B, S, w) in, the same launch
        hs, hT = ss.ssm_scan_blocked(a, b, h0)
        os_, oT = ops.linear_scan(a[..., 0], b[..., 0], h0[..., 0])
        check(torch.equal(os_, hs[..., 0]) and torch.equal(oT, hT[..., 0]),
              f"ops.linear_scan at (1, {S}, {w}) differs from the kernel "
              f"at N = 1")
        worst = max(worst, err)
        if ctl is not None:
            ctls.append(ctl)
    print(f"[kernels] ssm_scan at N = 1 ({arch}'s RG-LRU recurrence, B 1, "
          f"w {w}) at its serve's admit lengths {lengths}: max |kernel - "
          f"plain| {worst:.3e} (limit atol=rtol={SCAN_TOL}); the controls "
          f"with the carry zeroed every chunk (the plan's, or "
          f"{SCAN_CHUNK} steps on the single walk) off by {min(ctls):.3e} "
          f"to {max(ctls):.3e}, each rejected")
    before = {512: 0.0759, SERVE_LONG[arch]: 0.3234}
    for S in (512, SERVE_LONG[arch]):
        sets = [_scan_inputs(gen, dev, 1, S, w, 1) for _ in range(3)]
        a, b, h0 = sets[0]
        err, _ = _scan_check(f"ssm_scan N=1 (1, {S}, {w}) timed", a, b, h0)
        st = _stats(err, _work().ssm_scan(1, S, w, 1),
                    _time_ms([lambda s=s: ss.ssm_scan_blocked(*s)
                              for s in sets]),
                    _time_ms([lambda: ref.ssm_scan_ref(a, b, h0)], iters=2),
                    _time_ms([lambda s=s: torch.cumsum(s[1], dim=1)
                              for s in sets]))
        iss = _issue_ms(lambda: ss.ssm_scan_blocked(a, b, h0), iters=10)
        plan = scan_plan.split_plan(1, S, w, 1)
        print(f"[kernels] ssm_scan N=1 (1, {S}, {w}, 1) fp32: "
              f"max_abs_err={err:.3e} ms={st['ms']:.4f} (the single walk "
              f"in 5 CTAs: {before[S]}) plain_ms={st['plain_ms']:.4f} "
              f"yardstick torch.cumsum(b, dim=1) ms="
              f"{st['library_ms']:.4f} bound_ms={st['bound_ms']:.4f} "
              f"({st['bound_by']}: 12 bytes a step-channel, 8 a channel); "
              f"plan: {plan.n_chunks} chunks of {plan.chunk} steps x "
              f"{plan.n_tiles} tiles of {scan_plan.TILE} channels = "
              f"{plan.n_chunks * plan.n_tiles} CTAs of 128 threads; issued "
              f"one by one from Python: {iss:.4f} ms per call")
        if S == SERVE_LONG[arch]:
            # library_ms is null, the yardstick is printed above
            stats["ssm_scan"] = dict(st, library_ms=None)


#: (H, KV) of the main path's attention (internlm2-1.8b: 16 query heads
#: over 8 kv heads, G 2) and of starcoder2-3b (24 over 2, G 12: a 64-row
#: wgmma tile holds 5 1/3 query positions, and the decode's 8-row groups
#: take 12 heads as one full group and one half-full)
MAIN_HEADS = (16, 8)

#: (arch, (H, KV), hd) of the other archs phase 4 serves, whose head
#: layouts phase 2 checks at its shapes: starcoder2-3b (G 12),
#: qwen3-moe-30b-a3b (32 over 4, G 8: one full decode row group) and
#: internvl2-1b (14 over 2 at hd 64, G 7: a row group one row short)
OTHER_HEADS = (("starcoder2-3b", (24, 2), 128),
               ("qwen3-moe-30b-a3b", (32, 4), 128),
               ("internvl2-1b", (14, 2), 64))


def _paged_main_path(gen, dev, heads, stats, shares, issue, hd=128):
    """The paged decode and extend at phase 2's shapes, bf16, bs 16, for
    ``heads`` = (H, KV) and head dim ``hd``: a decode of B=8 at ragged
    lengths up to 2048 and an extend of (4, 256) at pos0 16-1792, each
    against its plain version with the bf16 rule and its control, SDPA,
    and 3 copies of its inputs for cold-L2 timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (H, KV), bs, max_len = heads, 16, 2048
    B, at = 8, f" H={H} KV={KV} hd={hd}"
    nb = max_len // bs
    lengths = torch.tensor([2048, 1, 1537, 300, 16, 977, 2000, 64],
                           dtype=torch.int32, device=dev)
    sets = [_paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd),
                          torch.bfloat16, dev) for _ in range(3)]
    q, kp, vp, bt = sets[0]
    out = ops.paged_decode_attention(q, kp, vp, bt, lengths)
    want = ref.paged_decode_attention_ref(*_f32(q, kp, vp), bt, lengths)
    err, share = _compare("decode main-path" + at, out, want)
    shares["paged_decode_attention"] = (share, _check_control(
        "decode main-path" + at, _plain_rounded_p(q[:, None], kp, vp, bt,
                                             lengths - 1), want))
    keep = (torch.arange(max_len, device=dev)[None, :] <
            lengths[:, None].long())[:, None, None, :]
    sd = [_sdpa_args(s[0][:, :, None], s[1], s[2], s[3], keep) for s in sets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True)[:, :, 0]
    _library_close("decode" + at, lib_out, want)
    issue["paged_decode_attention"] = _issue_ms(
        lambda: ops.paged_decode_attention(q, kp, vp, bt, lengths))
    stats["paged_decode_attention"] = _stats(
        err, _work().paged_decode_attention(B, H, KV, hd, bs, nb,
                                            lengths=lengths.tolist()),
        _time_ms([lambda s=s: ops.paged_decode_attention(
            s[0], s[1], s[2], s[3], lengths) for s in sets]),
        _time_ms([lambda s=s: ref.paged_decode_attention_ref(
            s[0], s[1], s[2], s[3], lengths) for s in sets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))

    Be, S = 4, 256
    pos0 = torch.tensor([16, 256, 768, 1792], dtype=torch.int32, device=dev)
    esets = [_paged_inputs(gen, Be, nb, bs, KV, hd, (Be, S, H, hd),
                           torch.bfloat16, dev) for _ in range(3)]
    q, kp, vp, bt = esets[0]
    out = ops.paged_extend_attention(q, kp, vp, bt, pos0)
    want = ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0)
    err, share = _compare("extend main-path" + at, out, want)
    shares["paged_extend_attention"] = (share, _check_control(
        "extend main-path" + at, _plain_rounded_p(q, kp, vp, bt, pos0), want))
    qpos = pos0[:, None].long() + torch.arange(S, device=dev)[None, :]
    keep = (torch.arange(max_len, device=dev)[None, None, :] <=
            qpos[:, :, None])[:, None]
    sd = [_sdpa_args(s[0].transpose(1, 2).contiguous(), s[1], s[2], s[3],
                     keep) for s in esets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True).transpose(1, 2)
    _library_close("extend" + at, lib_out, want)
    issue["paged_extend_attention"] = _issue_ms(
        lambda: ops.paged_extend_attention(q, kp, vp, bt, pos0))
    stats["paged_extend_attention"] = _stats(
        err, _work().paged_extend_attention(Be, S, H, KV, hd, bs, nb,
                                            pos0=pos0.tolist()),
        _time_ms([lambda s=s: ops.paged_extend_attention(
            s[0], s[1], s[2], s[3], pos0) for s in esets]),
        _time_ms([lambda s=s: ref.paged_extend_attention_ref(
            s[0], s[1], s[2], s[3], pos0) for s in esets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))


def _print_main_path(stats, shares, issue, label):
    for name, st in stats.items():
        if name not in shares:
            continue
        print(f"[kernels] {name}{label}: max_abs_err={st['max_abs_err']:.3e} "
              f"off_rounded={shares[name][0]:.4%} "
              f"(control with bf16 P: {shares[name][1]:.4%}) "
              f"ms={st['ms']:.4f} "
              f"plain_ms={st['plain_ms']:.4f} "
              f"library_ms={st['library_ms']:.4f} "
              f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']}); "
              f"device ms from a CUDA graph replay; issued one by one "
              f"from Python: {issue[name]:.4f} ms per call")


def _other_heads(gen, dev, arch, heads, hd):
    """The four attention kernels at ``arch``'s heads and head dim, bf16,
    at phase 2's shapes and lengths, each held to the bf16 rule with its
    control and timed beside its bound and SDPA."""
    stats, shares, issue = {}, {}, {}
    _paged_main_path(gen, dev, heads, stats, shares, issue, hd)
    _dense_main_path(gen, dev, heads, stats, shares, issue, hd)
    H, KV = heads
    _print_main_path(stats, shares, issue,
                     f" at {arch}'s heads (H {H}, KV {KV}, G {H // KV}, "
                     f"hd {hd})")


def _admit_shapes(arch, paged):
    """(S, pos0) of each admit of phase 4's requests on ``arch``'s paged
    or dense engine, in order (``paged`` asks for the paged engine; an
    arch that cannot page serves dense): every admit is batch-1 (phase 4
    checks it), its S the engine's bucket for the prompt, or on the paged
    path for the suffix past a prefix hit: the third request extends past
    the 256 tokens it shares with the first, at pos0 256.  gemma3-4b adds
    a ninth request past its window (SERVE_LONG)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeConfig
    from repro_torch.serving.engine import EngineFns
    cfg = get_config(arch)
    paged = paged and tfm.paged_supported(cfg, 2048)
    fns = EngineFns(cfg, ServeConfig(max_len=SERVE_MAX_LEN.get(arch, 2048)))
    # the lengths alone are used
    _, _, prompts = _serve_prompts(2, SERVE_LONG.get(arch, 0))
    pos0 = [256 if paged and i == 2 else 0 for i in range(len(prompts))]
    return [(fns.bucket(len(p) - p0), p0) for p, p0 in zip(prompts, pos0)]


def _window_keep(S, window, dev):
    """(1, S, S) causal mask, with ``t > s - window`` where ``window``."""
    import torch
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    if window:
        keep &= torch.ones(S, S, dtype=torch.bool, device=dev).triu(
            1 - window)
    return keep[None]


def _local_window(arch) -> int:
    """The window of ``arch``'s local layers, 0 if it has none."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    local = any(k == "L" for g in cfg.groups for k in g.pattern)
    return cfg.window if local else 0


def _serve_admits(gen, dev, arch, heads, hd):
    """Flash and the paged extend (bs 16) at the admit shapes of ``arch``'s
    phase-4 serves, bf16, each held to the bf16 rule with its control: at
    G 8 and G 7 most of them leave the last 64-row tile of S x G query
    rows partly filled.  An arch with local layers runs flash also at
    their window where a prompt is longer than it; one that cannot page
    (gemma3-4b's rings) has no extend admits."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as tfm
    (H, KV), bf = heads, torch.bfloat16
    at = f"{arch} admit (H {H}, KV {KV}, hd {hd})"
    errs, ctls = [], []
    flash = sorted({S for S, _ in _admit_shapes(arch, False)})
    wl = _local_window(arch)
    for S in flash:
        q = _randn(gen, (1, S, H, hd), bf, dev)
        k, v = (_randn(gen, (1, S, KV, hd), bf, dev) for _ in range(2))
        for window in (0, wl) if wl and S > wl else (0,):
            want = ref.flash_attention_ref(*_f32(q, k, v), causal=True,
                                           window=window)
            name = f"flash {at} S={S} window={window}"
            errs.append(_compare(name, ops.flash_attention(
                q, k, v, causal=True, window=window), want)[0])
            ctls.append(_check_control(
                name, _rounded_p(q, k, v, _window_keep(S, window, dev)),
                want))
    paged = tfm.paged_supported(get_config(arch), 2048)
    extend = sorted(set(_admit_shapes(arch, True))) if paged else []
    for S, p0 in extend:
        q, kp, vp, bt = _paged_inputs(gen, 1, -(-(p0 + S) // 16), 16, KV, hd,
                                      (1, S, H, hd), bf, dev)
        pos0 = torch.tensor([p0], dtype=torch.int32, device=dev)
        want = ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0)
        name = f"extend {at} S={S} pos0={p0}"
        errs.append(_compare(name, ops.paged_extend_attention(
            q, kp, vp, bt, pos0), want)[0])
        ctls.append(_check_control(
            name, _plain_rounded_p(q, kp, vp, bt, pos0), want))
    windows = f" (and window {wl} past it)" if wl else ""
    print(f"[kernels] {at}: flash at B 1, S {flash}{windows} and the paged "
          f"extend at B 1, (S, pos0) {extend}, the shapes phase 4's serves "
          f"admit: "
          f"max_abs_err={max(errs):.3e}, each within the bf16 rule; the "
          f"bf16-P controls off the rounded result in {min(ctls):.4%} to "
          f"{max(ctls):.4%} of elements, each rejected")


#: the speculative verify's shape at phase 7's serve: 8 windows of d+1 = 4
#: queries at ragged positions 301-329 that are not block-aligned (318 and
#: 329 straddle a 16-row page), and one at 510 whose last two queries lie
#: past the table's 512 keys
VERIFY_POS0 = (301, 307, 314, 318, 322, 325, 329, 510)
VERIFY_NB = 32


def _flash_window(gen, dev, arch, heads, hd, window, S):
    """Flash at ``arch``'s local layers' sliding window over one prompt of
    ``S`` tokens, bf16: the bf16 rule, its control, kernel, plain and SDPA
    times (SDPA with the band as a boolean mask) and the bound, counting
    only the (query, key) pairs the window lets through."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (H, KV), bf = heads, torch.bfloat16
    fsets = [[_randn(gen, sh, bf, dev) for sh in
              ((1, S, H, hd), (1, S, KV, hd), (1, S, KV, hd))]
             for _ in range(3)]
    q, k, v = fsets[0]
    name = f"flash {arch} window {window} (1, {S}) H={H} KV={KV} hd={hd}"
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True,
                                   window=window)
    err, share = _compare(name, ops.flash_attention(q, k, v, causal=True,
                                                    window=window), want)
    keep = _window_keep(S, window, dev)
    ctl = _check_control(name, _rounded_p(q, k, v, keep), want)
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in fsets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0], attn_mask=keep[:, None], enable_gqa=True).transpose(1, 2)
    _library_close(name, lib_out, want)
    st = _stats(
        err, _work().flash_attention(1, S, S, H, KV, hd, window=window),
        _time_ms([lambda s=s: ops.flash_attention(*s, causal=True,
                                                  window=window)
                  for s in fsets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s, causal=True,
                                                      window=window)
                  for s in fsets], iters=3),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, attn_mask=keep[:, None], enable_gqa=True) for a in sd]))
    print(f"[kernels] {name}: max_abs_err={err:.3e} off_rounded="
          f"{share:.4%} (control with bf16 P: {ctl:.4%}) ms={st['ms']:.4f} "
          f"plain_ms={st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
          f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']})")


def _verify_shape(gen, dev):
    """The paged extend at the verify shape (B 8, S 4, H 16, KV 8, hd 128,
    bs 16, a table of 32 blocks) against its plain version with the bf16
    rule and its control, with kernel, plain and SDPA times, the host's
    issue time and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, S, H, KV, hd, bs, nb = 8, 4, 16, 8, 128, 16, VERIFY_NB
    L = nb * bs
    pos0 = torch.tensor(VERIFY_POS0, dtype=torch.int32, device=dev)
    sets = [_paged_inputs(gen, B, nb, bs, KV, hd, (B, S, H, hd),
                          torch.bfloat16, dev) for _ in range(3)]
    q, kp, vp, bt = sets[0]
    out = ops.paged_extend_attention(q, kp, vp, bt, pos0)
    want = ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0)
    err, share = _compare("extend verify shape", out, want)
    ctl = _check_control("extend verify shape",
                         _plain_rounded_p(q, kp, vp, bt, pos0), want)
    qpos = pos0[:, None].long() + torch.arange(S, device=dev)[None, :]
    keep = (torch.arange(L, device=dev)[None, None, :] <=
            qpos[:, :, None])[:, None]
    sd = [_sdpa_args(s[0].transpose(1, 2).contiguous(), s[1], s[2], s[3],
                     keep) for s in sets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True).transpose(1, 2)
    _library_close("extend verify shape", lib_out, want)
    st = _stats(
        err, _work().paged_extend_attention(B, S, H, KV, hd, bs, nb,
                                            pos0=VERIFY_POS0),
        _time_ms([lambda s=s: ops.paged_extend_attention(
            s[0], s[1], s[2], s[3], pos0) for s in sets]),
        _time_ms([lambda s=s: ref.paged_extend_attention_ref(
            s[0], s[1], s[2], s[3], pos0) for s in sets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))
    issue = _issue_ms(lambda: ops.paged_extend_attention(q, kp, vp, bt, pos0))
    print(f"[kernels] paged_extend_attention at the verify shape (B 8, S 4, "
          f"pos0 {list(VERIFY_POS0)}, {L} keys a table, the last window "
          f"past it): max_abs_err={st['max_abs_err']:.3e} "
          f"off_rounded={share:.4%} (control with bf16 P: {ctl:.4%}) "
          f"ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} "
          f"library_ms={st['library_ms']:.4f} bound_ms={st['bound_ms']:.4f} "
          f"({st['bound_by']}); issued one by one from Python: "
          f"{issue:.4f} ms per call")


def _randn(gen, shape, dtype, dev):
    import torch
    return torch.randn(*shape, generator=gen, device=dev,
                       dtype=torch.float32).to(dtype)


def _dense_grid(gen, dtype, dname, hd, dev):
    """Flash attention and split-K decode at small shapes for one head
    dim and dtype; returns the number of checks."""
    import torch
    from repro_torch.kernels import ops, ref
    n = 0
    B, H, KV = 2, 8, 2
    for S in (37, 192):
        q = _randn(gen, (B, S, H, hd), dtype, dev)
        k, v = (_randn(gen, (B, S, KV, hd), dtype, dev) for _ in range(2))
        for causal, window in ((True, 0), (True, 64), (False, 0)):
            _compare(f"flash hd={hd} {dname} S={S} causal={causal} "
                     f"window={window}",
                     ops.flash_attention(q, k, v, causal=causal,
                                         window=window),
                     ref.flash_attention_ref(*_f32(q, k, v), causal=causal,
                                             window=window))
            n += 1
    L = 96
    # length 0 sees no key: the mean of V, as the TPU kernel gives
    lengths = torch.tensor([0, 1, 37, L], dtype=torch.int32, device=dev)
    for H_, KV_ in ((8, 2), (8, 1)):
        q = _randn(gen, (4, H_, hd), dtype, dev)
        k, v = (_randn(gen, (4, L, KV_, hd), dtype, dev) for _ in range(2))
        _compare(f"split-K decode hd={hd} {dname} G={H_ // KV_}",
                 ops.decode_attention(q, k, v, lengths),
                 ref.decode_attention_ref(*_f32(q, k, v), lengths))
        n += 1
    return n


# The edge shapes of the wgmma design's 64-row, 64-key tiles, as
# tests/test_torch_attention_sm90.py holds the plain versions against the
# JAX oracles and the Pallas kernels at them: flash at S one short of, at
# and one past a tile, two tiles and one past, and 200; G 1, 4, 8 (over 2
# and over 4 kv heads, qwen3-moe-30b-a3b's), 12 and 7 (internvl2-1b's; a
# tile's rows end inside a query position); the extend at bs 8 and 16
# with pos0 mid-page (the suffix and the last visible key straddle pages)
# and a row past the table's end, at G 4, 1, 12, 8 and 7.
FLASH_EDGE_S = (63, 64, 65, 129, 200)
FLASH_EDGE_G = ((8, 8), (16, 4), (16, 2), (24, 2), (32, 4), (14, 2))
EXTEND_EDGE_G = ((8, 2), (8, 8), (24, 2), (32, 4), (14, 2))
EXTEND_EDGES = ((8, 12, 37, (5, 21, 60)), (16, 6, 37, (13, 50, 70)),
                (8, 6, 20, (3, 40, 45)), (16, 4, 20, (0, 31, 60)))


def _attention_edges(gen, dev, hds=(32, 64, 128), extras=True):
    """The bf16 flash and extend kernels at the edge shapes above (head
    dims ``hds``), and with ``extras`` a long-prefix extend (one admit of
    256 tokens after 1,792 cached), then an extend whose pool rows that no
    row may see hold NaN, held against the plain version on the same pool
    with those rows zeroed (bs 16, 8, and 12, which the producer warp
    copies without TMA); each against the plain version's fp32 result at
    the bf16 limits."""
    import torch
    from repro_torch.kernels import ops, ref
    bf, n = torch.bfloat16, 0
    for hd in hds:
        for S in FLASH_EDGE_S:
            q = _randn(gen, (2, S, 8, hd), bf, dev)
            k, v = (_randn(gen, (2, S, 2, hd), bf, dev) for _ in range(2))
            for causal, window in ((True, 0), (True, 64), (False, 0)):
                _compare(f"flash edge hd={hd} S={S} causal={causal} "
                         f"window={window}",
                         ops.flash_attention(q, k, v, causal=causal,
                                             window=window),
                         ref.flash_attention_ref(*_f32(q, k, v),
                                                 causal=causal,
                                                 window=window))
                n += 1
        for H, KV in FLASH_EDGE_G:
            q = _randn(gen, (2, 129, H, hd), bf, dev)
            k, v = (_randn(gen, (2, 129, KV, hd), bf, dev) for _ in range(2))
            _compare(f"flash edge hd={hd} G={H // KV}",
                     ops.flash_attention(q, k, v, causal=True),
                     ref.flash_attention_ref(*_f32(q, k, v), causal=True))
            n += 1
        for bs, nb, S, p0 in EXTEND_EDGES:
            for H, KV in EXTEND_EDGE_G:
                q, kp, vp, bt = _paged_inputs(gen, len(p0), nb, bs, KV, hd,
                                              (len(p0), S, H, hd), bf, dev)
                pos0 = torch.tensor(p0, dtype=torch.int32, device=dev)
                _compare(f"extend edge hd={hd} bs={bs} pos0={p0} G="
                         f"{H // KV}",
                         ops.paged_extend_attention(q, kp, vp, bt, pos0),
                         ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt,
                                                        pos0))
                n += 1
    if not extras:
        torch.cuda.synchronize()
        print(f"[kernels] attention edges at hd {hds}: {n} checks passed: "
              f"flash at S {FLASH_EDGE_S} x causal / window 64 / "
              f"bidirectional and (H, KV) {FLASH_EDGE_G} at S 129; extend "
              f"at (bs, nb, S, pos0) {EXTEND_EDGES} x (H, KV) "
              f"{EXTEND_EDGE_G}")
        return
    # one long-prefix admit: 64 CTAs, each walking 1,824-2,048 keys
    q, kp, vp, bt = _paged_inputs(gen, 1, 128, 16, 8, 128, (1, 256, 16, 128),
                                  bf, dev)
    pos0 = torch.tensor([1792], dtype=torch.int32, device=dev)
    _compare("extend long prefix",
             ops.paged_extend_attention(q, kp, vp, bt, pos0),
             ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0))
    n += 1
    for bs in (16, 8, 12):
        B, nb, S, H, KV, hd = 4, 96 // bs, 37, 16, 8, 128
        q, kp, vp, bt = _paged_inputs(gen, B, nb, bs, KV, hd, (B, S, H, hd),
                                      bf, dev)
        pos0 = torch.tensor([5, 21, 44, 70], dtype=torch.int32, device=dev)
        last = (pos0.long() + S - 1).clamp(max=nb * bs - 1)   # per sequence
        seen = torch.zeros(kp.shape[:2], dtype=torch.bool, device=dev)
        key = torch.arange(nb * bs, device=dev)
        for b in range(B):
            rows = key[key <= last[b]]
            seen[bt[b].long()[rows // bs], rows % bs] = True
        nan_k, nan_v = kp.clone(), vp.clone()
        nan_k[~seen], nan_v[~seen] = float("nan"), float("nan")
        kp[~seen], vp[~seen] = 0, 0
        out = ops.paged_extend_attention(q, nan_k, nan_v, bt, pos0)
        _compare(f"extend NaN pool bs={bs}", out,
                 ref.paged_extend_attention_ref(*_f32(q, kp, vp), bt, pos0))
        n += 1
    torch.cuda.synchronize()
    print(f"[kernels] attention edges: {n} checks passed: flash at S "
          f"{FLASH_EDGE_S} x causal / window 64 / bidirectional and (H, KV) "
          f"{FLASH_EDGE_G} at S 129; extend at (bs, nb, S, pos0) "
          f"{EXTEND_EDGES} x (H, KV) {EXTEND_EDGE_G}; hd 32, 64 and 128; a "
          f"long-prefix extend (1, 256) at pos0 1792; "
          f"an extend whose unseen pool rows hold NaN (bs 16, "
          f"8, 12) equal to the plain version with them zeroed")


# The edge shapes of the split-key decode (chunks of decode_plan.CHUNK_KEYS
# keys a CTA), as tests/test_torch_decode_sm90.py holds the plain versions
# at them: lengths one short of, at and one past a chunk, one past two
# chunks, the longest row and a short row whose later chunks exit at once;
# pages (bs, nb) of 8, 16 and 32 rows, of 12 (straddling chunk ends) and
# of 128 (spanning two chunks); G 1, 4, 8 (one full row group, over 2 and
# over 4 kv heads), 12 (one full and one half-full), 16 (two) and 7 (one
# row short of a group).
DECODE_EDGE_PAGES = ((8, 40), (16, 20), (32, 10), (12, 27), (128, 3))
DECODE_EDGE_G = ((2, 2), (8, 2), (16, 2), (24, 2), (32, 2), (32, 4),
                 (14, 2))
#: hd 256: G 1 (gemma-7b), 2 (gemma3-4b), 10 (recurrentgemma-2b's MQA: one
#: full row group and one of 2) and 16 (two full groups)
DECODE_EDGE_G_256 = ((2, 2), (4, 2), (20, 2), (32, 2))


def _edge_lengths(max_keys):
    from repro_torch.kernels import decode_plan
    c = decode_plan.CHUNK_KEYS
    return [c - 1, c, c + 1, 2 * c + 1, max_keys, 3]


def _paged_decode_case(gen, dev, name, bs, nb, H, KV, hd, dtype, lengths,
                       table=None, nan=False):
    """The paged decode kernel against the plain version's fp32 result on
    the same inputs.  ``table`` edits the block table (the plain version
    reads it clamped into the pool, as the kernel does); ``nan`` fills the
    pool rows no live key reads with NaN (the plain version reads them
    zeroed).  A row of length 0 must give 0; returns the number of
    checks."""
    import torch
    from repro_torch.kernels import ops, ref
    B = len(lengths)
    q, kp, vp, bt = _paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd), dtype,
                                  dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if table is not None:
        table(bt, kp.shape[0])
    read_bt = bt.clamp(0, kp.shape[0] - 1)
    k_in, v_in = kp, vp
    if nan:
        seen = torch.zeros(kp.shape[:2], dtype=torch.bool, device=dev)
        for b, n_live in enumerate(lengths):
            t = torch.arange(min(n_live, nb * bs), device=dev)
            seen[read_bt[b].long()[t // bs], t % bs] = True
        k_in, v_in = kp.clone(), vp.clone()
        k_in[~seen], v_in[~seen] = float("nan"), float("nan")
        kp[~seen], vp[~seen] = 0, 0
    out = ops.paged_decode_attention(q, k_in, v_in, bt, ln)
    want = ref.paged_decode_attention_ref(*_f32(q, kp, vp), read_bt, ln)
    zero = [b for b, n_live in enumerate(lengths) if n_live == 0]
    check(all(bool((out[b] == 0).all()) for b in zero),
          f"{name}: a row of length 0 must give 0")
    live = [b for b in range(B) if b not in zero]
    _compare(name, out[live], want[live])
    return 1


def _dense_decode_case(gen, dev, name, L, H, KV, hd, dtype, lengths,
                       nan=False):
    """The split-K decode kernel against the plain version's fp32 result
    on the same inputs (a row of length 0 gives the mean of V in both);
    ``nan`` fills the cache rows past each row's live keys with NaN (the
    plain version reads them zeroed)."""
    import torch
    from repro_torch.kernels import ops, ref
    B = len(lengths)
    q = _randn(gen, (B, H, hd), dtype, dev)
    k, v = (_randn(gen, (B, L, KV, hd), dtype, dev) for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    k_in, v_in = k, v
    if nan:
        past = torch.arange(L, device=dev)[None, :] >= ln[:, None].long()
        k_in, v_in = k.clone(), v.clone()
        k_in[past], v_in[past] = float("nan"), float("nan")
        k[past], v[past] = 0, 0
    _compare(name, ops.decode_attention(q, k_in, v_in, ln),
             ref.decode_attention_ref(*_f32(q, k, v), ln))
    return 1


def _decode_edges(gen, dev, hds=(32, 64, 128), heads=DECODE_EDGE_G,
                  extra_hd=128):
    """Both decode kernels at the edge shapes above, fp32 and bf16, head
    dims ``hds`` and (H, KV) ``heads``; then at ``extra_hd``: a paged
    length past nb * bs with table entries past the pool, rows of length 0
    (paged: 0; dense: the mean of V), and caches whose rows past every
    live key hold NaN."""
    import torch

    def past_the_pool(bt, n):
        bt[0, 1], bt[2, 0], bt[3, -1] = n, n + 5, 2 ** 30

    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for hd in hds:
            for bs, nb in DECODE_EDGE_PAGES:
                n += _paged_decode_case(
                    gen, dev, f"paged decode edge {dn} hd={hd} bs={bs}", bs,
                    nb, 4, 2, hd, dtype, _edge_lengths(nb * bs))
            for H, KV in heads:
                n += _paged_decode_case(
                    gen, dev, f"paged decode edge {dn} hd={hd} G={H // KV}",
                    16, 20, H, KV, hd, dtype, _edge_lengths(320))
                n += _dense_decode_case(
                    gen, dev, f"split-K decode edge {dn} hd={hd} "
                    f"G={H // KV}", 320, H, KV, hd, dtype, _edge_lengths(320))
        xh = extra_hd
        n += _paged_decode_case(
            gen, dev, f"paged decode clamped {dn} hd={xh}", 16, 9, 16, 8, xh,
            dtype, [100, 144, 145, 1000], table=past_the_pool)
        n += _paged_decode_case(
            gen, dev, f"paged decode length 0 {dn} hd={xh}", 16, 16, 16, 8,
            xh, dtype, [0, 200, 5, 0])
        n += _dense_decode_case(
            gen, dev, f"split-K decode length 0 {dn} hd={xh}", 256, 16, 8,
            xh, dtype, [0, 200, 5, 0])
        nan_lengths = [1, 127, 129, 257, 383]
        for bs in (16, 12):
            n += _paged_decode_case(
                gen, dev, f"paged decode NaN pool {dn} bs={bs} hd={xh}", bs,
                384 // bs, 16, 8, xh, dtype, nan_lengths, nan=True)
        n += _dense_decode_case(
            gen, dev, f"split-K decode NaN cache {dn} hd={xh}", 384, 16, 8,
            xh, dtype, nan_lengths, nan=True)
    torch.cuda.synchronize()
    print(f"[kernels] decode edges: {n} checks passed, fp32 and bf16: "
          f"lengths {_edge_lengths('max_keys')} over paged (bs, nb) "
          f"{DECODE_EDGE_PAGES} at G 2 and (H, KV) {heads} (bs 16; "
          f"dense L 320), hd {hds}; at hd {xh} a paged length past nb * bs "
          f"with table entries past the pool (read clamped); rows of length "
          f"0 (paged 0, dense the mean of V); caches whose rows past every "
          f"live key hold NaN (paged bs 16 and 12, dense) equal to the "
          f"plain version with them zeroed")


# (label, lengths, rows of a table or stripe): phase 2's ragged decode,
# the serves' decode syncs (8 slots at ~300-330-token contexts), and one
# short row, where the device time is a few microseconds and the host's
# issue time is the host's cost alone
DECODE_SHAPES = (
    ("phase 2's shape (B 8, lengths 2048 ... 64)",
     (2048, 1, 1537, 300, 16, 977, 2000, 64), 2048),
    ("the serves' shape (B 8, lengths 301-329)", tuple(range(301, 330, 4)),
     2048),
    ("a tiny shape (B 1, length 8)", (8,), 64))


def _decode_bench(gen, dev, lengths, max_len):
    """Both decode kernels in bf16 at the main path's widths (H 16, KV 8,
    hd 128; paged bs 16) for rows of ``lengths`` keys in tables or stripes
    of ``max_len`` rows: each held against its plain version at the bf16
    limits, then device ms (3 input copies), the plain version's and
    SDPA's ms, the bound and the host's issue ms.  Returns name -> stats.
    (scripts/attention_ab.py runs it on older checkouts too.)"""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    H, KV, hd, bs, bf = 16, 8, 128, 16, torch.bfloat16
    B, nb = len(lengths), max_len // bs
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    keep = (torch.arange(max_len, device=dev)[None, :] <
            ln[:, None].long())[:, None, None, :]
    psets = [_paged_inputs(gen, B, nb, bs, KV, hd, (B, H, hd), bf, dev)
             for _ in range(3)]
    dsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, H, hd), (B, max_len, KV, hd), (B, max_len, KV, hd))]
             for _ in range(3)]
    cases = {
        "paged_decode_attention": (
            psets, ops.paged_decode_attention, ref.paged_decode_attention_ref,
            [_sdpa_args(s[0][:, :, None], s[1], s[2], s[3], keep)
             for s in psets],
            _work().paged_decode_attention(B, H, KV, hd, bs, nb,
                                           lengths=lengths)),
        "decode_attention": (
            dsets, ops.decode_attention, ref.decode_attention_ref,
            [(s[0][:, :, None], s[1].transpose(1, 2).contiguous(),
              s[2].transpose(1, 2).contiguous(), keep) for s in dsets],
            _work().decode_attention(B, H, KV, hd, max_len,
                                     lengths=lengths))}
    out = {}
    for name, (sets, kernel, plain, sd, w) in cases.items():
        err, _ = _compare(f"{name} {lengths}", kernel(*sets[0], ln),
                          plain(*_f32(*sets[0][:3]), *sets[0][3:], ln))
        st = _stats(
            err, w,
            _time_ms([lambda s=s: kernel(*s, ln) for s in sets]),
            _time_ms([lambda s=s: plain(*s, ln) for s in sets]),
            _time_ms([lambda a=a: F.scaled_dot_product_attention(
                *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))
        st["issue_ms"] = _issue_ms(lambda: kernel(*sets[0], ln))
        out[name] = st
    return out


def _decode_row(st, lengths, max_len) -> str:
    """A _decode_bench row, with the CTAs of the split plan that hold live
    keys among those launched (the main path's H 16, KV 8)."""
    from repro_torch.kernels import decode_plan
    c = decode_plan.CHUNK_KEYS
    n_chunks = decode_plan.split_plan(len(lengths), 16, 8, 128,
                                      max_len).n_chunks
    return (f"max_abs_err={st['max_abs_err']:.3e} ms={st['ms']:.4f} "
            f"plain_ms={st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
            f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']}) issue_ms="
            f"{st['issue_ms']:.4f} live_ctas="
            f"{8 * sum(-(-x // c) for x in lengths)} of "
            f"{8 * len(lengths) * n_chunks}")


def _dense_main_path(gen, dev, heads, stats, shares, issue, hd=128):
    """Flash attention and split-K decode at the dense path's shapes, bf16,
    for ``heads`` = (H, KV) and head dim ``hd``: a causal prefill of B=3,
    S=512 and a decode of B=8 over L=2048 at ragged lengths, each on 3
    copies of its inputs for cold-L2 timing."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    (H, KV), bf = heads, torch.bfloat16
    at = f" H={H} KV={KV} hd={hd}"

    B, S = 3, 512
    fsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
             for _ in range(3)]
    q, k, v = fsets[0]
    out = ops.flash_attention(q, k, v, causal=True)
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True)
    err, share = _compare("flash main-path" + at, out, want)
    keep = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
    shares["flash_attention"] = (share, _check_control(
        "flash main-path" + at, _rounded_p(q, k, v, keep.expand(B, S, S)),
        want))
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in fsets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0], is_causal=True, enable_gqa=True).transpose(1, 2)
    _library_close("flash" + at, lib_out, want)
    issue["flash_attention"] = _issue_ms(
        lambda: ops.flash_attention(q, k, v, causal=True))
    stats["flash_attention"] = _stats(
        err, _work().flash_attention(B, S, S, H, KV, hd),
        _time_ms([lambda s=s: ops.flash_attention(*s, causal=True)
                  for s in fsets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s, causal=True)
                  for s in fsets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True) for a in sd]))

    B, L = 8, 2048
    lengths = torch.tensor([2048, 1, 1537, 300, 16, 977, 2000, 64],
                           dtype=torch.int32, device=dev)
    dsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd))]
             for _ in range(3)]
    q, k, v = dsets[0]
    out = ops.decode_attention(q, k, v, lengths)
    want = ref.decode_attention_ref(*_f32(q, k, v), lengths)
    err, share = _compare("split-K decode main-path" + at, out, want)
    keep = (torch.arange(L, device=dev)[None, :] <
            lengths[:, None].long())[:, None]           # (B, 1, L)
    shares["decode_attention"] = (share, _check_control(
        "split-K decode main-path" + at, _rounded_p(q[:, None], k, v, keep),
        want))
    sd = [(st[0][:, :, None], st[1].transpose(1, 2).contiguous(),
           st[2].transpose(1, 2).contiguous(), keep[:, None])
          for st in dsets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True)[:, :, 0]
    _library_close("split-K decode" + at, lib_out, want)
    issue["decode_attention"] = _issue_ms(
        lambda: ops.decode_attention(q, k, v, lengths))
    stats["decode_attention"] = _stats(
        err, _work().decode_attention(B, H, KV, hd, L,
                                      lengths=lengths.tolist()),
        _time_ms([lambda s=s: ops.decode_attention(*s, lengths)
                  for s in dsets]),
        _time_ms([lambda s=s: ref.decode_attention_ref(*s, lengths)
                  for s in dsets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))


def _flash_long(gen, dev):
    """Flash at (B=1, S=2048) causal, above the bf16 ridge: checked, and
    timed beside its bound, plain version and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    B, S, H, KV, hd, bf = 1, 2048, 16, 8, 128, torch.bfloat16
    fsets = [[_randn(gen, sh, bf, dev) for sh in
              ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
             for _ in range(3)]
    q, k, v = fsets[0]
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True)
    err, share = _compare("flash (1, 2048)",
                          ops.flash_attention(q, k, v, causal=True), want)
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in fsets]
    st = _stats(
        err, _work().flash_attention(B, S, S, H, KV, hd),
        _time_ms([lambda s=s: ops.flash_attention(*s, causal=True)
                  for s in fsets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s, causal=True)
                  for s in fsets], iters=3),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, is_causal=True, enable_gqa=True) for a in sd]))
    print(f"[kernels] flash_attention (1, 2048) causal bf16: max_abs_err="
          f"{err:.3e} off_rounded={share:.4%} ms={st['ms']:.4f} plain_ms="
          f"{st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
          f"bound_ms={st['bound_ms']:.4f} ({st['bound_by']})")


# The flash backward's shapes: the training step's (internlm2-1.8b, B 4 x
# S 1024), then the edges of its tiles: S one short of, at and one past
# 64 (the dQ kernel's key tile, a warpgroup's keys and, at G 1, a row
# tile), 129 and 200 (ragged), and 1; G 1, 2, 8 and 12; hd 16, 32, 64 and
# 256; gemma3-4b's window 1024 over S 2048 (H 8, KV 4, hd 256);
# bidirectional, alone and with a window.  Then, after those and their
# controls: S at the edges of the dK / dV kernel's 128-key tile
# (BWD_EDGE_S_KEYS, and at hd 256 its 64-key tile), and whole-query row
# tiles with rows left over (BWD_LEFTOVER_G: internvl2-1b's G 7 at hd 64,
# 63 of 64 rows; recurrentgemma-2b's G 10 at hd 256, 60 rows).
BWD_TRAIN = (4, 1024, 16, 8, 128)
BWD_EDGE_S = (1, 63, 64, 65, 129, 200)
BWD_EDGE_G = ((8, 8), (16, 8), (16, 2), (24, 2))
BWD_EDGE_HD = (16, 32, 64, 256)
BWD_EDGE_S_KEYS = (127, 128, 255, 256, 257)
BWD_LEFTOVER_G = ((14, 2, 64), (10, 1, 256))
# the dK / dV kernel's key tile at hd 128 (csrc/flash_attention_bwd.cu,
# kernels/flash_bwd_plan.py), whose edges the checks above take
BWD_KEY_TILE = 128


def _plain_scores(q32, k32, causal, window, shift=0, t_end=None):
    """The masked scaled scores (B, KV, G, S, T) of fp32 q (B,S,H,hd) over
    k (B,T,KV,hd); with ``shift``, a causal mask that lets query s see
    keys up to s + shift; with ``t_end``, the keys from t_end on
    masked."""
    import torch
    from repro_torch.kernels import ref
    B, S, H, hd = q32.shape
    T, KV = k32.shape[1], k32.shape[2]
    qg = q32.reshape(B, S, KV, H // KV, hd)
    sc = torch.einsum("bqkgh,bskh->bkgqs", qg, k32) / math.sqrt(hd)
    s = torch.arange(S, device=q32.device)
    t = torch.arange(T, device=q32.device)
    ok = torch.ones((S, T), dtype=torch.bool, device=q32.device)
    if causal:
        ok &= t[None, :] <= s[:, None] + shift
    if window:
        ok &= t[None, :] > s[:, None] - window
    if t_end is not None:
        ok &= t[None, :] < t_end
    return torch.where(ok, sc, ref.NEG_INF)


def _plain_grads(q, k, v, dout, causal, window, shift=0, t_end=None):
    """Autograd through the plain version in fp32: (out, lse, (dq, dk,
    dv)); with ``shift``, the control whose causal mask lets query s see
    keys up to s + shift; with ``t_end``, the control that drops the keys
    from t_end on."""
    import torch
    q32, k32, v32 = (t.float().requires_grad_(True) for t in (q, k, v))
    B, S, H, hd = q.shape
    KV = k.shape[2]
    sc = _plain_scores(q32, k32, causal, window, shift, t_end)
    lse = torch.logsumexp(sc, -1).permute(0, 3, 1, 2).reshape(B, S, H)
    out = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(sc, -1),
                       v32).reshape(B, S, H, hd)
    grads = torch.autograd.grad(out, (q32, k32, v32), dout.float())
    return out.detach(), lse.detach(), grads


def _kernel_grads(q, k, v, dout, causal, window):
    """The forward kernel with its lse, then the backward kernel."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    out = fa._forward(q, k, v, causal, window, lse)
    return out, lse, fa.flash_attention_bwd_bshd(
        q, k, v, out, dout, lse, causal=causal, window=window)


def _plain_p_ds(q32, k32, v32, do32):
    """The plain causal P and dS (B, KV, G, S, S) in fp32."""
    import torch
    B, S, H, hd = q32.shape
    KV = k32.shape[2]
    P = torch.softmax(_plain_scores(q32, k32, True, 0), -1)
    dog = do32.reshape(B, S, KV, H // KV, hd)
    out = torch.einsum("bkgqs,bskh->bqkgh", P, v32)
    delta = (dog * out).sum(-1).permute(0, 2, 3, 1)[..., None]
    dS = P * (torch.einsum("bqkgh,bskh->bkgqs", dog, v32) - delta)
    return P, dS, dog


def _dq_without_last_tile(q, k, v, dout):
    """The dq-only control: the plain causal dq in fp32 with each query of
    the second half of the rows leaving out the keys of its last visible
    key tile (64 keys, the dQ kernel's), as a kernel that skipped the
    diagonal tile there would; dk and dv are untouched."""
    import torch
    from repro_torch.kernels import flash_bwd_plan as fbp
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
    B, S, H, hd = q.shape
    _, dS, _ = _plain_p_ds(q32, k32, v32, do32)
    t = torch.arange(S, device=q.device)
    tile = fbp.SUB_TILE
    last = t[None, :] >= (t[:, None] // tile) * tile
    dS = torch.where(last & (t[:, None] >= S // 2), 0.0, dS)
    return torch.einsum("bkgqs,bskh->bqkgh", dS, k32).reshape(
        B, S, H, hd) / math.sqrt(hd)


def _dkdv_without_diagonal(q, k, v, dout):
    """The dK / dV-only control: the plain causal dk and dv in fp32 with
    each key tile (BWD_KEY_TILE keys, the dK / dV kernel's at hd 128)
    leaving out its diagonal row tile, the first its walk visits (the
    queries of the row tile that holds the tile's first key), as a kernel
    that skipped it would; dq is untouched."""
    import torch
    from repro_torch.kernels import flash_bwd_plan as fbp
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, dout))
    B, S, H, hd = q.shape
    KV = k.shape[2]
    P, dS, dog = _plain_p_ds(q32, k32, v32, do32)
    nq = fbp.row_tiles(S, H // KV).nq
    t = torch.arange(S, device=q.device)
    first = (t // BWD_KEY_TILE) * BWD_KEY_TILE // nq * nq  # per key
    drop = (t[:, None] >= first[None, :]) & (t[:, None] < first[None, :] +
                                             nq)
    P = torch.where(drop, 0.0, P)
    dS = torch.where(drop, 0.0, dS)
    qg = q32.reshape(B, S, KV, H // KV, hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", dS, qg) / math.sqrt(hd)
    dv = torch.einsum("bkgqs,bqkgh->bskh", P, dog)
    return dk, dv


def _grad_readings(got, want):
    """Two readings for each of (dq, dk, dv): max |got - want| over the
    largest |want| of that gradient, and mean |got - want| over its mean
    |want|.  A gradient that is zero in the plain result (at S 1 a
    query's only key gives dq = dk = 0) is read against the largest and
    the mean magnitude of the three instead."""
    tops = [w.abs().max().item() for w in want]
    means = [w.abs().mean().item() for w in want]
    out = []
    for g, w, top, mean in zip(got, want, tops, means):
        err = (g.float() - w).abs()
        if top == 0:
            top, mean = max(tops), max(means)
        out.append((err.max().item() / top, err.mean().item() / mean))
    return out


def _show(readings) -> str:
    return "/".join(f"{m:.2e} ({a:.2e})" for m, a in readings)


def _bwd_check(name, q, k, v, dout, causal, window):
    """The backward kernel against the plain version's fp32 gradients at
    GRAD_REL, its lse at LSE_TOL, and a second call bit for bit; prints
    each reading beside its limit and returns the largest absolute
    error."""
    import torch
    dname = str(q.dtype).split(".")[1]
    limit = GRAD_REL[dname]
    _, lse, got = _kernel_grads(q, k, v, dout, causal, window)
    _, want_lse, want = _plain_grads(q, k, v, dout, causal, window)
    readings = _grad_readings(got, want)
    lse_err = (lse - want_lse).abs().max().item()
    check(all(torch.isfinite(g.float()).all() for g in got),
          f"flash bwd {name}: non-finite gradient")
    check(max(max(r) for r in readings) <= limit and lse_err <= LSE_TOL,
          f"flash bwd {name}: dq/dk/dv off the plain fp32 gradients by "
          f"{_show(readings)} of each one's largest (mean) magnitude "
          f"(limit {limit}); lse off by {lse_err:.3e} (limit {LSE_TOL})")
    again = _kernel_grads(q, k, v, dout, causal, window)[2]
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"flash bwd {name}: a second call gave other bits")
    print(f"[kernels] flash bwd {name} {dname}: dq/dk/dv "
          f"{_show(readings)} of each one's max (mean) (limit {limit}); "
          f"lse {lse_err:.2e} (limit {LSE_TOL}); second call identical")
    return max((g.float() - w).abs().max().item()
               for g, w in zip(got, want))


def _time_bwd_ms(forward, sets, iters: int = 10) -> float:
    """Device ms of one backward, as :func:`_time_ms` times a call: each
    input set's forward runs eagerly on the timing stream (its output
    requires grad), then ``iters`` calls of ``torch.autograd.grad`` on
    those graphs, cycling through the sets, are captured in one CUDA graph
    and a replay is timed with CUDA events, so only the backward's work
    is counted."""
    import torch
    stream = _timing_stream()
    stream.wait_stream(torch.cuda.current_stream())
    graphs = []
    with torch.cuda.stream(stream):
        for inputs, dout in sets:
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            out = forward(*leaves)
            torch.autograd.grad(out, leaves, dout, retain_graph=True)
            graphs.append((out, leaves, dout))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for i in range(iters):
            out, leaves, dout = graphs[i % len(graphs)]
            torch.autograd.grad(out, leaves, dout, retain_graph=True)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def _flash_bwd_checks(gen, dev, stats):
    """The flash backward (``ops.flash_attention`` under grad): at the
    training shape, timed beside its bound, the plain version's autograd
    and SDPA's flash backward; at the edges; in fp32; with its controls;
    then at the bf16 kernels' own tile edges."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16

    def inputs(B, S, H, KV, hd, dtype):
        return [_randn(gen, sh, dtype, dev) for sh in
                ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                 (B, S, H, hd))]

    B, S, H, KV, hd = BWD_TRAIN
    sets = [inputs(B, S, H, KV, hd, bf) for _ in range(3)]
    err = _bwd_check(f"training shape (B {B}, S {S}, H {H}, KV {KV}, hd "
                     f"{hd}) causal", *sets[0], True, 0)
    n = 1
    for S_ in BWD_EDGE_S:
        _bwd_check(f"edge S {S_} (H 4, KV 2, hd 128) causal",
                   *inputs(2, S_, 4, 2, 128, bf), True, 0)
        n += 1
    for H_, KV_ in BWD_EDGE_G:
        _bwd_check(f"edge G {H_ // KV_} (H {H_}, KV {KV_}, S 129, hd 128)",
                   *inputs(1, 129, H_, KV_, 128, bf), True, 0)
        n += 1
    for hd_ in BWD_EDGE_HD:
        _bwd_check(f"edge hd {hd_} (S 129, H 8, KV 4) causal",
                   *inputs(1, 129, 8, 4, hd_, bf), True, 0)
        n += 1
    _bwd_check("window 1024 over S 2048 (H 8, KV 4, hd 256)",
               *inputs(1, 2048, 8, 4, 256, bf), True, 1024)
    _bwd_check("bidirectional (S 200, H 4, KV 2, hd 128)",
               *inputs(2, 200, 4, 2, 128, bf), False, 0)
    _bwd_check("bidirectional window 64 (S 200, H 4, KV 2, hd 128)",
               *inputs(2, 200, 4, 2, 128, bf), False, 64)
    n += 3
    for hd_ in (16, 32, 64, 128, 256):
        _bwd_check(f"fp32 hd {hd_} (S 65, H 4, KV 2) causal",
                   *inputs(2, 65, 4, 2, hd_, torch.float32), True, 0)
        n += 1
    _bwd_check("fp32 bidirectional (S 65, H 4, KV 2, hd 128)",
               *inputs(2, 65, 4, 2, 128, torch.float32), False, 0)
    _bwd_check("fp32 window 16 (S 65, H 4, KV 2, hd 128)",
               *inputs(2, 65, 4, 2, 128, torch.float32), True, 16)
    n += 2
    # the controls: a mask that lets each query see one key too many
    # (each of dq, dk and dv must move past the limit), and, at the
    # training shape, dq alone losing the last visible key tile of the
    # rows that see 512 keys or more (both of its readings past it)
    bf_limit = GRAD_REL["bfloat16"]
    q, k, v, dout = inputs(2, 129, 4, 2, 128, bf)
    want = _plain_grads(q, k, v, dout, True, 0)[2]
    ctl = _grad_readings(_plain_grads(q, k, v, dout, True, 0, shift=1)[2],
                         want)
    check(all(r[0] > bf_limit for r in ctl),
          f"flash bwd control: a mask one key too wide moves dq/dk/dv by "
          f"only {_show(ctl)}; the limit {bf_limit} cannot see it in each")
    train_want = _plain_grads(*sets[0], True, 0)[2]
    dq_want = train_want[0]
    (dq_ctl,) = _grad_readings([_dq_without_last_tile(*sets[0])], [dq_want])
    check(min(dq_ctl) > bf_limit,
          f"flash bwd dq control: dq without the last key tile in the "
          f"second half of the rows moves it by only {_show([dq_ctl])}; "
          f"the limit {bf_limit} cannot see it")
    kv_ctl = _grad_readings(_dkdv_without_diagonal(*sets[0]),
                            train_want[1:])
    check(all(min(r) > bf_limit for r in kv_ctl),
          f"flash bwd dk/dv control: dk and dv without each key tile's "
          f"diagonal row tile move them by only {_show(kv_ctl)}; the limit "
          f"{bf_limit} cannot see it in both readings")
    print(f"[kernels] flash bwd controls, beyond the bf16 limit {bf_limit} "
          f"as they must be: causal mask one key too wide (S 129): dq/dk/dv "
          f"{_show(ctl)} of max (mean); dq without the last key tile in rows "
          f"{S // 2}-{S - 1} (training shape): {_show([dq_ctl])}; dk/dv "
          f"without each {BWD_KEY_TILE}-key tile's diagonal row tile "
          f"(training shape): {_show(kv_ctl)}")
    # after the controls, so that the checks above keep their draws: the
    # dK / dV kernel's key tile edges, and row tiles with rows left over
    for S_ in BWD_EDGE_S_KEYS:
        _bwd_check(f"key tile edge S {S_} (H 4, KV 2, hd 128) causal",
                   *inputs(2, S_, 4, 2, 128, bf), True, 0)
        n += 1
    for S_ in (63, 65, 127):
        _bwd_check(f"key tile edge S {S_} (H 8, KV 4, hd 256) causal",
                   *inputs(1, S_, 8, 4, 256, bf), True, 0)
        n += 1
    for H_, KV_, hd_ in BWD_LEFTOVER_G:
        G_ = H_ // KV_
        for causal, window in ((True, 0), (True, 48), (False, 0)):
            _bwd_check(f"G {G_} rows left over (H {H_}, KV {KV_}, hd {hd_}, "
                       f"S 200) causal={causal} window={window}",
                       *inputs(1, 200, H_, KV_, hd_, bf), causal, window)
            n += 1
    torch.cuda.synchronize()
    print(f"[kernels] flash bwd: {n} checks passed (bf16 within "
          f"{GRAD_REL['bfloat16']} and fp32 within {GRAD_REL['float32']} of "
          f"each gradient's largest and mean magnitude, lse within "
          f"{LSE_TOL}); edges S {BWD_EDGE_S} and {BWD_EDGE_S_KEYS}, (H, KV) "
          f"{BWD_EDGE_G}, hd {BWD_EDGE_HD}, rows left over at (H, KV, hd) "
          f"{BWD_LEFTOVER_G}")

    # timed at the training shape: the kernel through its autograd
    # Function, the plain version under autograd, SDPA's flash backward
    # on K/V expanded to the 16 query heads (its dk/dv are per query head)
    G = H // KV
    kernel_sets = [(st[:3], st[3]) for st in sets]
    sd_sets = [([st[0].transpose(1, 2).contiguous(),
                 st[1].repeat_interleave(G, 2).transpose(1, 2).contiguous(),
                 st[2].repeat_interleave(G, 2).transpose(1, 2).contiguous()],
                st[3].transpose(1, 2).contiguous()) for st in sets]
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib_out = F.scaled_dot_product_attention(*sd_sets[0][0],
                                                 is_causal=True)
        _library_close("flash bwd's SDPA forward", lib_out.transpose(1, 2),
                       ref.flash_attention_ref(*_f32(*sets[0][:3]),
                                               causal=True))
        library_ms = _time_bwd_ms(
            lambda q, k, v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), sd_sets)
    ms = _time_bwd_ms(lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True), kernel_sets)
    plain_ms = _time_bwd_ms(lambda q, k, v: ref.flash_attention_ref(
        q, k, v, causal=True), kernel_sets, iters=3)
    w = _work().flash_attention_bwd(B, S, S, H, KV, hd)
    ops_n, by = w.flops, w.bytes
    stats["flash_attention_bwd"] = _stats(err, w, ms, plain_ms, library_ms)
    st = stats["flash_attention_bwd"]
    print(f"[kernels] flash_attention_bwd at the training shape (B {B}, S "
          f"{S}, H {H}, KV {KV}, hd {hd}, causal, bf16): max_abs_err="
          f"{err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (SDPA flash backward) bound_ms="
          f"{st['bound_ms']:.4f} ({st['bound_by']}: {ops_n / 1e9:.2f} GFLOP, "
          f"{by / 1e6:.1f} MB)")


# whisper-base's attention on the kernels (H 8, KV 8, hd 64: G 1): the
# encoder's bidirectional flash over S 1,500 frames (30 s of audio), the
# cross attention's flash over T 1,500 encoder states at the serve's
# prompts (B 8 x S 4, Whisper's start-of-transcript sequence; B 4 x S
# 224), the decoder's split-K decode over its self cache (L 448, the
# serve's max_len, at ragged lengths) and over the cross cache (L 1,500,
# every row live), and a training step's three backward shapes at B 8:
# the cross attention (S 448 over T 1,500), the encoder (S 1,500
# bidirectional) and the decoder (S 448 causal).  Then flash at T != S
# at the tiles' edges: T one short of, at and one past 64, 1,500 and one
# past; S 1, 63 and 65; G 1, 2 and 8 at hd 64 and 128.
WHISPER_HEADS = (8, 8, 64)
WHISPER_T = 1500
WHISPER_MAX_LEN = 448
WHISPER_CROSS = ((8, 4), (4, 224))
WHISPER_BWD = (("cross", 448, WHISPER_T, False), ("encoder", WHISPER_T,
                                                  WHISPER_T, False),
               ("decoder", 448, 448, True))
WHISPER_EDGE_T = (63, 64, 65, 1500, 1501)
WHISPER_EDGE_S = (1, 63, 65)
WHISPER_EDGE_HEADS = ((8, 8), (8, 4), (8, 1))
WHISPER_SELF_LENGTHS = (5, 68, 127, 128, 129, 300, 447, 448)


def _whisper_flash(gen, dev, name, B, S, T, heads, causal):
    """bf16 flash at S queries over T keys, on 3 copies of the inputs,
    against the plain version's fp32 result with its control (P rounded
    to bf16), timed beside the plain version and SDPA, and its bound:
    (max abs error, share off the rounded result, the control's share,
    stats)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    H, KV, hd = heads
    sets = [[_randn(gen, sh, torch.bfloat16, dev) for sh in
             ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd))]
            for _ in range(3)]
    q, k, v = sets[0]
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=causal)
    err, share = _compare(name, ops.flash_attention(q, k, v, causal=causal),
                          want)
    keep = torch.ones(S, T, dtype=torch.bool, device=dev)
    if causal:
        keep = keep.tril()
    ctl = _check_control(name, _rounded_p(q, k, v, keep.expand(B, S, T)),
                         want)
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in sets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0], is_causal=causal, enable_gqa=True).transpose(1, 2)
    _library_close(name, lib_out, want)
    st = _stats(
        err, _work().flash_attention(B, S, T, H, KV, hd, causal=causal),
        _time_ms([lambda s=s: ops.flash_attention(*s, causal=causal)
                  for s in sets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s, causal=causal)
                  for s in sets], iters=3),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a, is_causal=causal, enable_gqa=True) for a in sd]))
    return err, share, ctl, st


def _whisper_decode(gen, dev, name, B, L, lengths, heads):
    """The split-K decode at G 1 over L rows at ``lengths``, bf16, with its
    control, timed beside the plain version, SDPA and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    H, KV, hd = heads
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sets = [[_randn(gen, sh, torch.bfloat16, dev) for sh in
             ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd))]
            for _ in range(3)]
    q, k, v = sets[0]
    want = ref.decode_attention_ref(*_f32(q, k, v), lengths)
    err, share = _compare(name, ops.decode_attention(q, k, v, lengths), want)
    keep = (torch.arange(L, device=dev)[None, :] <
            lengths[:, None].long())[:, None]           # (B, 1, L)
    ctl = _check_control(name, _rounded_p(q[:, None], k, v, keep), want)
    sd = [(st[0][:, :, None], st[1].transpose(1, 2).contiguous(),
           st[2].transpose(1, 2).contiguous(), keep[:, None])
          for st in sets]
    lib_out = F.scaled_dot_product_attention(
        *sd[0][:3], attn_mask=sd[0][3], enable_gqa=True)[:, :, 0]
    _library_close(name, lib_out, want)
    st = _stats(
        err, _work().decode_attention(B, H, KV, hd, L,
                                      lengths=lengths.tolist()),
        _time_ms([lambda s=s: ops.decode_attention(*s, lengths)
                  for s in sets]),
        _time_ms([lambda s=s: ref.decode_attention_ref(*s, lengths)
                  for s in sets]),
        _time_ms([lambda a=a: F.scaled_dot_product_attention(
            *a[:3], attn_mask=a[3], enable_gqa=True) for a in sd]))
    return share, ctl, st


def _row(st) -> str:
    return (f"ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} "
            f"library_ms={st['library_ms']:.4f} bound_ms="
            f"{st['bound_ms']:.4f} ({st['bound_by']})")


def _whisper_kernel_checks(gen, dev):
    """whisper-base's shapes on flash (T != S for the cross attention),
    its backward and the split-K decode (the shapes above), each held to
    its plain version with the bf16 rule and its control (the backward
    with GRAD_REL and a control that drops the last key tile of the
    cross attention), and timed."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import ops, ref
    bf = torch.bfloat16
    H, KV, hd = WHISPER_HEADS
    at = f"H {H}, KV {KV}, hd {hd}"
    for label, B, S, T, causal in (
            [("cross", B_, S_, WHISPER_T, False)
             for B_, S_ in WHISPER_CROSS] +
            [("encoder", 8, WHISPER_T, WHISPER_T, False)]):
        name = f"whisper flash {label} (B {B}, S {S}, T {T}, {at})"
        err, share, ctl, st = _whisper_flash(gen, dev, name, B, S, T,
                                             WHISPER_HEADS, causal)
        print(f"[kernels] {name} bf16: max_abs_err={err:.3e} "
              f"off_rounded={share:.4%} control={ctl:.2%} {_row(st)}")
    edges = [(bf, H_, KV_, hd_, T, S) for (H_, KV_), hd_, T, S in
             itertools.product(WHISPER_EDGE_HEADS, (64, 128),
                               WHISPER_EDGE_T, WHISPER_EDGE_S)]
    edges += [(torch.float32, H_, KV_, hd_, T, S)
              for (H_, KV_), hd_ in (((8, 8), 64), ((8, 1), 128))
              for T, S in itertools.product((63, 65, 1501), (1, 65))]
    for dtype, H_, KV_, hd_, T, S in edges:
        q = _randn(gen, (2, S, H_, hd_), dtype, dev)
        k, v = (_randn(gen, (2, T, KV_, hd_), dtype, dev) for _ in "kv")
        _compare(f"whisper flash edge {dtype} (S {S}, T {T}, H {H_}, KV "
                 f"{KV_}, hd {hd_})",
                 ops.flash_attention(q, k, v, causal=False),
                 ref.flash_attention_ref(*_f32(q, k, v), causal=False))
    n = len(edges)
    torch.cuda.synchronize()
    print(f"[kernels] whisper flash at T != S: {n} edge checks passed "
          f"(bf16 at T {WHISPER_EDGE_T} x S {WHISPER_EDGE_S} x (H, KV) "
          f"{WHISPER_EDGE_HEADS} x hd 64 and 128; fp32 at T 63, 65, 1501 "
          f"x S 1, 65)")

    for label, L, lengths in (
            ("self", WHISPER_MAX_LEN, WHISPER_SELF_LENGTHS),
            ("cross", WHISPER_T, (WHISPER_T,) * 8)):
        name = f"whisper split-K decode {label} (B 8, L {L}, {at})"
        share, ctl, st = _whisper_decode(gen, dev, name, 8, L, lengths,
                                         WHISPER_HEADS)
        print(f"[kernels] {name} bf16 lengths {lengths}: off_rounded="
              f"{share:.4%} control={ctl:.2%} {_row(st)}")

    limit = GRAD_REL["bfloat16"]
    for label, S, T, causal in WHISPER_BWD:
        B = 8
        sets = [[_randn(gen, sh, bf, dev) for sh in
                 ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                  (B, S, H, hd))] for _ in range(3)]
        name = f"whisper {label} (B {B}, S {S}, T {T}, {at}) " + (
            "causal" if causal else "bidirectional")
        err = _bwd_check(name, *sets[0], causal, 0)
        if label == "cross":
            # the control: the keys of the last dK / dV tile (the 128 that
            # hold T's partial 64-key tile) left out, as a grid one tile
            # short would; each of dq, dk and dv must move past the limit
            cut = (T - 1) // BWD_KEY_TILE * BWD_KEY_TILE
            want = _plain_grads(*sets[0], False, 0)[2]
            ctl = _grad_readings(_plain_grads(*sets[0], False, 0,
                                              t_end=cut)[2], want)
            check(all(r[0] > limit for r in ctl),
                  f"flash bwd {name} control: keys {cut}-{T - 1} dropped "
                  f"move dq/dk/dv by only {_show(ctl)}; the limit {limit} "
                  f"cannot see it in each")
            print(f"[kernels] flash bwd {name} control, beyond the bf16 "
                  f"limit {limit} as it must be: keys {cut}-{T - 1} "
                  f"dropped: dq/dk/dv {_show(ctl)} of max (mean)")
        kernel_sets = [(st[:3], st[3]) for st in sets]
        sd_sets = [([t.transpose(1, 2).contiguous() for t in st[:3]],
                    st[3].transpose(1, 2).contiguous()) for st in sets]
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib_out = F.scaled_dot_product_attention(*sd_sets[0][0],
                                                     is_causal=causal)
            _library_close(f"flash bwd {name}'s SDPA forward",
                           lib_out.transpose(1, 2),
                           ref.flash_attention_ref(*_f32(*sets[0][:3]),
                                                   causal=causal))
            library_ms = _time_bwd_ms(
                lambda q, k, v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal), sd_sets)
        ms = _time_bwd_ms(lambda q, k, v: ops.flash_attention(
            q, k, v, causal=causal), kernel_sets)
        plain_ms = _time_bwd_ms(lambda q, k, v: ref.flash_attention_ref(
            q, k, v, causal=causal), kernel_sets, iters=3)
        w = _work().flash_attention_bwd(B, S, T, H, KV, hd, causal=causal)
        ops_n, by = w.flops, w.bytes
        st = _stats(err, w, ms, plain_ms, library_ms)
        print(f"[kernels] flash_attention_bwd whisper {label} (B {B}, S {S}, "
              f"T {T}, {at}, bf16): max_abs_err={err:.3e} {_row(st)} "
              f"(SDPA flash backward; {ops_n / 1e9:.2f} GFLOP, "
              f"{by / 1e6:.1f} MB)")


#: flash at a query offset, at the sequence-sharded prefill's shapes: the
#: second rank's S 2,048 queries over T 4,096 keys at internlm2-1.8b's
#: heads, causal (phase 11 (e)); gemma3-4b's local heads (hd 256) on a
#: halo, window 1,024, S 1,024 queries over T = 1,024 + 1,024
OFFSET_SHAPES = (("internlm2-1.8b", (16, 8), 128, 2048, 4096, 0),
                 ("gemma3-4b", (8, 4), 256, 1024, 2048, 1024))
#: the offset grid: (S, T) pairs across the wgmma kernel's 64-row and
#: 64-key tiles (shifts T - S of 1, 63, 64, 65 and 700) x the three masks
#: x G 1 and 2, at hd 64 and 128, in fp32 (the CUDA-core kernel) and bf16
OFFSET_GRID = ((63, 64), (65, 129), (64, 128), (130, 195), (200, 900))


def _offset_keep(S, T, window, dev, causal=True):
    """(1, S, T): query s at key position s + T - S sees key t iff t <= it
    (where ``causal``) and t > it - window (where ``window``)."""
    import torch
    at = torch.arange(S, device=dev)[:, None] + (T - S)
    t = torch.arange(T, device=dev)[None, :]
    keep = t <= at if causal else torch.ones_like(t <= at)
    if window:
        keep &= t > at - window
    return keep[None]


def _offset_flash(gen, dev, arch, heads, hd, S, T, window):
    """bf16 flash at a query offset (S queries over T >= S keys) against
    the plain version with the bf16 rule and its control, kernel, plain
    and SDPA times, and the bound from the (query, key) pairs the mask
    lets through.  Causal, SDPA takes ``causal_lower_right(S, T)`` on its
    fused backends, with K/V expanded to H heads beforehand (that path
    takes no ``enable_gqa``); a window has no fused form, and SDPA takes
    the band as a boolean mask."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels import ops, ref
    (H, KV), bf = heads, torch.bfloat16
    sets = [[_randn(gen, sh, bf, dev) for sh in
             ((1, S, H, hd), (1, T, KV, hd), (1, T, KV, hd))]
            for _ in range(3)]
    q, k, v = sets[0]
    name = (f"flash at a query offset {arch} (1, S {S} over T {T}) H={H} "
            f"KV={KV} hd={hd} window={window}")
    want = ref.flash_attention_ref(*_f32(q, k, v), causal=True,
                                   window=window)
    err, share = _compare(name, ops.flash_attention(q, k, v, causal=True,
                                                    window=window), want)
    keep = _offset_keep(S, T, window, dev)
    ctl = _check_control(name, _rounded_p(q, k, v, keep), want)
    sd = [[t.transpose(1, 2).contiguous() for t in st] for st in sets]
    if window:
        def library(a):
            return F.scaled_dot_product_attention(
                *a, attn_mask=keep[:, None], enable_gqa=True)
    else:
        sd = [[a[0]] + [t.repeat_interleave(H // KV, dim=1) for t in a[1:]]
              for a in sd]
        band = causal_lower_right(S, T)

        def library(a):
            return F.scaled_dot_product_attention(*a, attn_mask=band)
    _library_close(name, library(sd[0]).transpose(1, 2), want)
    pairs = int(keep.sum())
    w = _work().flash_attention(1, S, T, H, KV, hd, window=window)
    check(w.flops == 4 * hd * H * pairs,
          f"{name}: kernels/work.py counts {w.flops} operations, the mask "
          f"{4 * hd * H * pairs}")
    st = _stats(
        err, w,
        _time_ms([lambda s=s: ops.flash_attention(*s, causal=True,
                                                  window=window)
                  for s in sets]),
        _time_ms([lambda s=s: ref.flash_attention_ref(*s, causal=True,
                                                      window=window)
                  for s in sets], iters=3),
        _time_ms([lambda a=a: library(a) for a in sd]))
    print(f"[kernels] {name}: max_abs_err={err:.3e} off_rounded="
          f"{share:.4%} (control with bf16 P: {ctl:.4%}) pairs={pairs} "
          f"ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} library_ms="
          f"{st['library_ms']:.4f} bound_ms={st['bound_ms']:.4f} "
          f"({st['bound_by']})")
    return st


def _offset_flash_checks(gen, dev):
    """Flash at a query offset (T > S under a mask): both sources on the
    offset grid, then the sequence-sharded prefill's two shapes timed.
    Returns the first shape's stats (PERF.md row 3k)."""
    import torch
    from repro_torch.kernels import ops, ref
    n, worst = 0, {}
    for dtype in (torch.float32, torch.bfloat16):
        for hd in (64, 128):
            for H, KV in ((4, 4), (8, 4)):
                for S, T in OFFSET_GRID:
                    for causal, window in ((True, 0), (False, 48),
                                           (True, 48)):
                        q = _randn(gen, (1, S, H, hd), dtype, dev)
                        k, v = (_randn(gen, (1, T, KV, hd), dtype, dev)
                                for _ in range(2))
                        name = (f"flash offset {dtype} hd={hd} G={H // KV} "
                                f"S={S} T={T} causal={causal} "
                                f"window={window}")
                        want = ref.flash_attention_ref(
                            *_f32(q, k, v), causal=causal, window=window)
                        err, _ = _compare(name, ops.flash_attention(
                            q, k, v, causal=causal, window=window), want)
                        key = str(dtype).split(".")[1]
                        worst[key] = max(worst.get(key, 0.0), err)
                        if dtype == torch.bfloat16:
                            _check_control(name, _rounded_p(q, k, v, (
                                _offset_keep(S, T, window, dev, causal))),
                                want)
                        n += 1
    print(f"[kernels] flash at a query offset: {n} checks, (S, T) "
          f"{list(OFFSET_GRID)} x causal / window 48 / both x G 1, 2 x hd "
          f"64, 128 x fp32 (max_abs_err {worst['float32']:.3e}, atol=rtol="
          f"{FP32_TOL}) and bf16 (max_abs_err {worst['bfloat16']:.3e}, "
          f"each within the bf16 rule and its control rejected)")
    first = None
    for arch, heads, hd, S, T, window in OFFSET_SHAPES:
        st = _offset_flash(gen, dev, arch, heads, hd, S, T, window)
        first = first or st
    return first


def _pair_inputs(gen, dev, N, M, d, dtype, wdtype=None):
    """Random pair-score inputs: claims (N, d) and evidence (M, d)
    N(0, 1), W N(0, 1)/sqrt(d), w N(0, 1), bias 0.3."""
    import torch
    wdtype = wdtype or dtype
    W = _randn(gen, (d, d), torch.float32, dev) / math.sqrt(d)
    return (_randn(gen, (N, d), dtype, dev), _randn(gen, (M, d), dtype, dev),
            W.to(wdtype), _randn(gen, (2 * d,), wdtype, dev),
            torch.tensor(0.3, device=dev))


def _margot_pair_inputs(dev, N, M):
    """MARGOT's own pair-score inputs at d = 1024: L2-normalized hashed
    bag-of-words rows of the synthetic corpus (claims the first N, evidence
    the next M) and the MARGOT link model."""
    import torch
    from repro_torch.configs.margot_svm import PIPELINE
    from repro_torch.data.text import margot_models
    from repro_torch.launch.argmining import make_corpus
    X = torch.from_numpy(make_corpus(N + M, PIPELINE.feat_dim)[0]).to(dev)
    link = margot_models(PIPELINE, device=dev)["link"]
    return (X[:N].contiguous(), X[N:].contiguous(), link["W"], link["w"],
            link["bias"])


def _pair_check(name, C, E, W, w, b, control=False, route=None):
    """The kernel's pair score against the plain version run in fp64 on
    the same inputs, at max |kernel - fp64| <= PAIR_REL * max |fp64|, on
    the route the plan gives (which must be ``route`` when given); a
    second call on the same inputs must give the same bits; with
    ``control``, the plain version in fp32 with TF32 on must fail that
    limit.  Returns (max abs error, its share of max |fp64|, the
    control's share or None)."""
    import torch
    from repro_torch.kernels import ops, pair_plan, ref
    N, d = C.shape
    got = pair_plan.plan(N, E.shape[0], d, C.dtype, W.dtype).route
    check(route is None or got == route,
          f"{name}: planned on the {got} route, not {route}")
    link = {"W": W, "w": w, "bias": b}
    out = ops.pair_score(link, C, E)
    check(out.dtype == torch.float32 and
          tuple(out.shape) == (C.shape[0], E.shape[0]) and
          bool(torch.isfinite(out).all()), f"{name}: bad output")
    check(torch.equal(ops.pair_score(link, C, E), out),
          f"{name}: two calls on the same inputs differ")
    want = ref.pair_score_ref(*(t.double() for t in (C, E, W, w[:d], w[d:],
                                                     b)))
    scale = want.abs().max().item()
    err = (out.double() - want).abs().max().item()
    check(err <= PAIR_REL * scale, f"{name} ({got}): max |kernel - fp64| "
          f"{err:.3e} is {err / scale:.3e} of max |score|, limit {PAIR_REL}")
    ctl = None
    if control:
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = ref.pair_score_ref(C, E, W, w[:d], w[d:], b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        ctl = (tf32.double() - want).abs().max().item() / scale
        check(ctl > PAIR_REL, f"{name}: the TF32 control is off by only "
              f"{ctl:.3e} of max |score|: the limit {PAIR_REL} cannot see "
              f"TF32")
    return err, err / scale, ctl


def _pair_library(C, E, W, w, b):
    """The yardstick: the same function as cuBLAS and elementwise calls
    (no single PyTorch call computes it), TF32 off."""
    d = C.shape[1]
    return (C @ W) @ E.T + (C @ w[:d])[:, None] + (E @ w[d:])[None, :] + b


def _pair_score_checks(gen, dev, stats, issue):
    """The pair score against its plain version in fp64: a grid of small
    shapes in fp32 and bf16 on both routes (the wgmma route's edges: N and
    M not multiples of its 128 x 128 tiles, a depth split with a ragged
    last chunk, d = 4k but not a multiple of 32), then the batch path's
    shape (256, 512, 1024) and the stream's (1024, 1024, 1024) in fp32 on
    MARGOT's features and on random inputs, each with the TF32 control;
    every call repeated for bit-identical scores; times at both shapes."""
    import torch
    from repro_torch.kernels import ops, pair_plan, ref
    worst = {"wgmma": 0.0, "simt": 0.0}
    n = 0
    for N, M, d in ((64, 128, 256), (100, 60, 128), (128, 128, 512),
                    (1, 1, 1024), (257, 513, 130), (100, 60, 132),
                    (257, 513, 1028)):
        for dtype in (torch.float32, torch.bfloat16):
            route = ("wgmma" if dtype == torch.float32 and d % 4 == 0
                     else "simt")
            name = f"pair_score ({N}, {M}, {d}) {str(dtype)[6:]}"
            _, rel, _ = _pair_check(
                name, *_pair_inputs(gen, dev, N, M, d, dtype), route=route)
            pl = pair_plan.plan(N, M, d, dtype, dtype)
            split = (f" (splits {pl.project.split} x {pl.project.per_split}"
                     f" / {pl.score.split} x {pl.score.per_split} steps)"
                     if pl.project else "")
            print(f"[kernels] {name}: route {route}{split}, |kernel - "
                  f"fp64| / max|score| {rel:.3e}")
            worst[route] = max(worst[route], rel)
            n += 1
    _, rel, _ = _pair_check("pair_score bf16 claims, fp32 W",
                            *_pair_inputs(gen, dev, 100, 60, 128,
                                          torch.bfloat16, torch.float32),
                            route="simt")
    worst["simt"] = max(worst["simt"], rel)
    print(f"[kernels] pair_score grid: {n + 1} checks (+ bf16 claims with "
          f"fp32 W on the simt route), each repeated bit for bit, passed: "
          f"max |kernel - fp64| <= {worst['wgmma']:.3e} (wgmma), "
          f"{worst['simt']:.3e} (simt) of max |score| (limit {PAIR_REL})")
    d = 1024
    for label, N, M in (("batch", 256, 512), ("stream", 1024, 1024)):
        read = {}
        for kind, args in (("margot", _margot_pair_inputs(dev, N, M)),
                           ("random", _pair_inputs(gen, dev, N, M, d,
                                                   torch.float32))):
            read[kind] = _pair_check(f"pair_score {label} {kind}", *args,
                                     control=True, route="wgmma")
        sets = [_pair_inputs(gen, dev, N, M, d, torch.float32)
                for _ in range(3)]
        link = lambda s: {"W": s[2], "w": s[3], "bias": s[4]}  # noqa
        C, E, W, w, b = sets[0]
        check(torch.allclose(_pair_library(C, E, W, w, b),
                             ref.pair_score_ref(C, E, W, w[:d], w[d:], b),
                             atol=1e-4, rtol=1e-4),
              "pair_score: the yardstick computes another function")
        w = _work().pair_score(N, M, d)
        st = _stats(
            read["random"][0], w,
            _time_ms([lambda s=s: ops.pair_score(link(s), s[0], s[1])
                      for s in sets]),
            _time_ms([lambda s=s: ref.pair_score_ref(
                s[0], s[1], s[2], s[3][:d], s[3][d:], s[4]) for s in sets]),
            _time_ms([lambda s=s: _pair_library(*s) for s in sets]))
        iss = _issue_ms(lambda: ops.pair_score(link(sets[0]), C, E))
        core_ms = _work().pair_score(N, M, d, route="simt").bound_ms()[0]
        pl = pair_plan.plan(N, M, d, torch.float32, torch.float32)
        print(f"[kernels] pair_score {label} ({N}, {M}, {d}) fp32, route "
              f"wgmma ({pl.project.ctas} + {pl.score.ctas} CTAs, splits "
              f"{pl.project.split} / {pl.score.split}), repeat calls bit-"
              f"identical: |kernel - fp64| / max|score| "
              f"margot={read['margot'][1]:.3e} random={read['random'][1]:.3e}"
              f", TF32 control margot={read['margot'][2]:.3e} "
              f"random={read['random'][2]:.3e} (limit {PAIR_REL}); "
              f"max_abs_err={st['max_abs_err']:.3e} ms={st['ms']:.4f} "
              f"plain_ms={st['plain_ms']:.4f} library_ms="
              f"{st['library_ms']:.4f} (cuBLAS GEMMs + elementwise, several "
              f"calls) bound_ms={st['bound_ms']:.4f} ({st['bound_by']}, "
              f"3xTF32 at 495/3 TFLOP/s; on the CUDA cores' 67 TFLOP/s "
              f"{core_ms:.4f}); issued one by one from Python: {iss:.4f} ms "
              f"per call")
        if label == "batch":
            # no one PyTorch call computes this function: the JSON line's
            # library_ms is null, the yardstick is printed above
            stats["pair_score"] = dict(st, library_ms=None)
            issue["pair_score"] = iss


def _scan_inputs(gen, dev, B, S, D, N):
    """Stable dynamics as tests/test_kernels.py:189-194: a in (0, 1), b
    small, h0 nonzero; fp32."""
    import torch
    a = torch.sigmoid(_randn(gen, (B, S, D, N), torch.float32, dev))
    b = _randn(gen, (B, S, D, N), torch.float32, dev) * 0.1
    return a, b, _randn(gen, (B, D, N), torch.float32, dev)


def _chunk_zeroed(a, b, h0, period):
    """The control: the plain recurrence with the carry zeroed at every
    ``period``-step chunk boundary."""
    import torch
    hs, h = torch.empty_like(b), h0
    for t in range(a.shape[1]):
        if t and t % period == 0:
            h = torch.zeros_like(h)
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    return hs, h


def _control_period(shape):
    """The control's period for a scan of ``shape``: the plan's chunk where
    the chunked kernel runs (a lost carry there fails the limit), else
    SCAN_CHUNK, the TPU kernel's chunk."""
    from repro_torch.kernels import scan_plan
    plan = scan_plan.split_plan(*shape)
    return plan.chunk if plan.n_chunks > 1 else SCAN_CHUNK


def _within(name, pairs):
    """Each (got, want) pair finite, of one shape and within atol = rtol =
    SCAN_TOL; returns the largest |got - want|."""
    import torch
    err = 0.0
    for got, w, what in pairs:
        check(got.shape == w.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: bad output")
        err = max(err, (got - w).abs().max().item())
        check(torch.allclose(got, w, atol=SCAN_TOL, rtol=SCAN_TOL),
              f"{name} {what}: max_abs_err {err:.3e} beyond atol=rtol="
              f"{SCAN_TOL}")
    return err


def _rejected(name, pairs):
    """The control's pairs must fail the SCAN_TOL limit, or the check could
    not see a lost carry; returns the control's largest error."""
    import torch
    check(not all(torch.allclose(c, w, atol=SCAN_TOL, rtol=SCAN_TOL)
                  for c, w in pairs),
          f"{name}: the chunk-zeroed control passes the limit {SCAN_TOL}: "
          f"the check cannot see the carry")
    return max((c - w).abs().max().item() for c, w in pairs)


def _scan_check(name, a, b, h0, control=False):
    """The kernel's (h_seq, h_final) against the plain version's on the
    same inputs at atol = rtol = SCAN_TOL; with ``control`` the
    chunk-zeroed recurrence (period: :func:`_control_period`) must fail
    that limit.  Returns (max abs error of both outputs, the control's max
    abs error or None)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    hs, hT = ss.ssm_scan_blocked(a, b, h0)
    torch.cuda.synchronize()
    want = ref.ssm_scan_ref(a, b, h0)
    err = _within(name, ((hs, want[0], "h_seq"), (hT, want[1], "h_final")))
    ctl = None
    if control:
        zs, zT = _chunk_zeroed(a, b, h0, _control_period(tuple(a.shape)))
        ctl = _rejected(name, ((zs, want[0]), (zT, want[1])))
    return err, ctl


#: the Mamba serve's prompt lengths in submit order: same lengths
#: adjacent, so each run of them shares one exact-length admit
MAMBA_PROMPTS = (512, 512, 512, 512, 1000, 256, 256, 100)


def _mamba_admits(lengths=MAMBA_PROMPTS):
    """(n, S) of each admit of prompts of ``lengths`` (the Mamba serve's),
    in order: the dense engine admits a run of one exact length as one
    batch (its 8 slots are all free when they arrive); phase 4 checks that
    it did."""
    return [(len(list(run)), S) for S, run in itertools.groupby(lengths)]


def _ssm_scan_checks(gen, dev, stats, issue):
    """The scan kernel at N 8 and 16 against its plain version: a grid of
    small shapes (N 8 and 16, S 1 and ragged, an odd D N and a misaligned
    view; the plan runs them on the chunked kernel, the odd and misaligned
    ones on its one-channel threads), then the Mamba serve's admit shapes
    on the single walk with the chunk-zeroed control and times, and the
    chunked kernel forced at the largest of them and over a sweep of
    channel counts (:func:`_scan_crossover`).  The Mamba serve's op runs
    the fused kernel (:func:`_fused_scan_checks`)."""
    import torch
    from repro_torch.kernels import ref, scan_plan
    from repro_torch.kernels import ssm_scan as ss
    worst = 0.0
    grid = [(2, S, 64, N) for N in (8, 16) for S in (1, 37, 130)]
    grid += [(3, 9, 5, 3)]
    for B, S, D, N in grid:
        err, _ = _scan_check(f"ssm_scan ({B}, {S}, {D}, {N})",
                             *_scan_inputs(gen, dev, B, S, D, N))
        worst = max(worst, err)
    a, b, h0 = _scan_inputs(gen, dev, 2, 37, 64, 8)
    buf = torch.empty(a.numel() + 1, device=dev)
    buf[1:].copy_(a.reshape(-1))
    err, _ = _scan_check("ssm_scan misaligned view",
                         buf[1:].view(a.shape), b, h0)
    worst = max(worst, err)
    plans = [scan_plan.split_plan(*g)[:2] for g in grid]
    print(f"[kernels] ssm_scan grid: {len(grid) + 1} checks over (B, S, D, "
          f"N) in {grid} (the plan's (chunk, n_chunks): {plans}) and a "
          f"view starting 4 bytes past a 16-byte boundary passed: max "
          f"|kernel - plain| {worst:.3e} (limit atol=rtol={SCAN_TOL})")
    # its own generator for an admit shape past these three, so that the
    # checks after this one keep their inputs from ``gen``
    own = torch.Generator(device=dev).manual_seed(25)
    for B, S in _mamba_admits():
        D, N = 8192, 16
        a, b, h0 = _scan_inputs(
            gen if (B, S) in ((4, 512), (1, 1000), (1, 100)) else own, dev,
            B, S, D, N)
        err, ctl = _scan_check(f"ssm_scan ({B}, {S}, {D}, {N})", a, b, h0,
                               control=True)
        st = _stats(err, _work().ssm_scan(B, S, D, N),
                    _time_ms([lambda: ss.ssm_scan_blocked(a, b, h0)],
                             iters=5),
                    _time_ms([lambda: ref.ssm_scan_ref(a, b, h0)], iters=2),
                    _time_ms([lambda: torch.cumsum(b, dim=1)], iters=5))
        iss = _issue_ms(lambda: ss.ssm_scan_blocked(a, b, h0), iters=10)
        before = " (this design's earlier record: 1.0865)" \
            if (B, S) == (4, 512) else ""
        print(f"[kernels] ssm_scan ({B}, {S}, {D}, {N}) fp32, the single "
              f"walk (plan: {scan_plan.split_plan(B, S, D, N).n_chunks} "
              f"chunk): max_abs_err={err:.3e} (limit atol=rtol={SCAN_TOL}; "
              f"control with the carry zeroed every {SCAN_CHUNK} steps: "
              f"{ctl:.3e}) ms={st['ms']:.4f}{before} plain_ms="
              f"{st['plain_ms']:.4f} yardstick torch.cumsum(b_bar, dim=1) "
              f"ms={st['library_ms']:.4f} (one tensor read, one written: 2/3 "
              f"of the scan's bytes; no PyTorch call computes the "
              f"recurrence) bound_ms={st['bound_ms']:.4f} "
              f"({st['bound_by']}); issued one by one from Python: "
              f"{iss:.4f} ms per call")
        del a, b, h0
    torch.cuda.empty_cache()
    _scan_crossover(dev)


#: the crossover sweep's shapes at S 512, by single-walk threads (B ceil(D
#: N / 4)): recurrentgemma-2b's row (640), 4,096 to 65,536, the Mamba 4 x
#: 512 admit's (131,072)
CROSSOVER_SHAPES = ((1, 512, 2560, 1), (1, 512, 16384, 1),
                    (1, 512, 32768, 1), (1, 512, 65536, 1),
                    (1, 512, 131072, 1), (2, 512, 131072, 1),
                    (4, 512, 8192, 16))


def _scan_crossover(dev):
    """The scan's two kernels on the same inputs over a sweep of channel
    counts at S 512: the single walk (``scan_plan.FILL_THREADS`` patched to
    0) against the chunked kernel (patched above every shape), each held
    against the plain version and timed, beside the route the plan picks
    (it takes the single walk from ``FILL_THREADS`` threads up).  Its
    own generator: the checks after it keep their inputs."""
    import torch
    from repro_torch.kernels import scan_plan
    from repro_torch.kernels import ssm_scan as ss
    gen = torch.Generator(device=dev).manual_seed(26)
    rows = []
    for B, S, D, N in CROSSOVER_SHAPES:
        a, b, h0 = _scan_inputs(gen, dev, B, S, D, N)
        ms = {}
        for route, fill in (("single", 0), ("chunked", 2**62)):
            with mock.patch.object(scan_plan, "FILL_THREADS", fill):
                plan = scan_plan.split_plan(B, S, D, N)
                _scan_check(f"ssm_scan {route} ({B}, {S}, {D}, {N})", a, b,
                            h0)
                ms[route] = _time_ms(
                    [lambda: ss.ssm_scan_blocked(a, b, h0)], iters=5)
                if route == "chunked":
                    ctas = plan.n_chunks * B * plan.n_tiles
                    split = f"{plan.chunk} x {plan.n_chunks} chunks"
        picked = "chunked" if scan_plan.split_plan(B, S, D, N).n_chunks > 1 \
            else "single"
        threads = B * -(-D * N // 4)
        rows.append((threads, ms["single"], ms["chunked"], picked))
        print(f"[kernels] ssm_scan crossover ({B}, {S}, {D}, {N}): "
              f"{threads} single-walk threads ms={ms['single']:.4f}; chunked "
              f"({split}, {ctas} CTAs) ms={ms['chunked']:.4f}; both within "
              f"atol=rtol={SCAN_TOL} of the plain version; the plan takes "
              f"the {picked} kernel")
        del a, b, h0
    torch.cuda.empty_cache()
    faster = [t for t, single, chunked, _ in rows if single <= chunked]
    wrong = [t for t, single, chunked, picked in rows
             if picked != ("single" if single <= chunked else "chunked")]
    print(f"[kernels] ssm_scan crossover at S 512: the single walk is no "
          f"slower than the chunked kernel at "
          f"{faster or 'none'} single-walk threads of "
          f"{[t for t, *_ in rows]}; the plan's FILL_THREADS = "
          f"{scan_plan.FILL_THREADS} picks the slower kernel at "
          f"{wrong or 'none'}")


#: the fused kernel's stage (FCHUNK in csrc/selective_scan.cu): the
#: control zeroes the carry at its boundaries
FUSED_STAGE = 32


def _fused_inputs(gen, dev, B, S, di, N, with_h0=True, dt_rank=7):
    """The op's inputs as the Mamba block makes them: softplus dt, A =
    -exp(.), Bc and Cc cut by ``torch.split`` from one projection (strided
    views, unit stride over N); fp32."""
    import torch
    import torch.nn.functional as F
    rnd = lambda *s: _randn(gen, s, torch.float32, dev)  # noqa: E731
    xc, dt = rnd(B, S, di), F.softplus(rnd(B, S, di))
    _, Bc, Cc = torch.split(rnd(B, S, dt_rank + 2 * N), [dt_rank, N, N],
                            dim=-1)
    A, D = -torch.exp(rnd(di, N)), rnd(di)
    return xc, dt, Bc, Cc, A, D, (rnd(B, di, N) if with_h0 else None)


def _compose(scan, xc, dt, Bc, Cc, A, D, h0=None):
    """The op as ``ops.ssm_scan`` composed it before the fused kernel:
    a_bar and b_bar built in torch, ``scan(a_bar, b_bar, h0)``, the C
    contraction by einsum.  With the scan kernel it is the route the fused
    kernel replaces; with :func:`_chunk_zeroed` it is the fused check's
    control."""
    import torch
    a_bar = (dt[..., None] * A).exp_()
    b_bar = (dt * xc)[..., None] * Bc[:, :, None, :]
    if h0 is None:
        h0 = torch.zeros((xc.shape[0], xc.shape[2], A.shape[-1]),
                         dtype=torch.float32, device=xc.device)
    h_seq, h_fin = scan(a_bar, b_bar, h0)
    return torch.einsum("bsdn,bsn->bsd", h_seq, Cc) + xc * D, h_fin


def _composed_route(*args, **kw):
    """The route the fused kernel replaces: :func:`_compose` around the
    scan kernel."""
    from repro_torch.kernels import ssm_scan as ss
    return _compose(ss.ssm_scan_blocked, *args, **kw)


def _fused_check(name, args, control=False):
    """The fused kernel's (y, h_final) against ``ref.selective_scan_ref``
    at SCAN_TOL; with ``control`` the carry zeroed every FUSED_STAGE steps
    must fail it.  Returns (max abs error, the control's or None)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    y, hT = ss.selective_scan_fused(*args)
    torch.cuda.synchronize()
    wy, wT = ref.selective_scan_ref(*args)
    err = _within(name, ((y, wy, "y"), (hT, wT, "h_final")))
    ctl = None
    if control:
        zy, zT = _compose(lambda a, b, h: _chunk_zeroed(a, b, h,
                                                        FUSED_STAGE), *args)
        ctl = _rejected(name, ((zy, wy), (zT, wT)))
    return err, ctl


def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.split()[0]
    return float(out) * 1e6


def _fused_scan_checks(gen, dev, stats, issue):
    """The fused selective scan (``ops.ssm_scan`` on a CUDA tensor) against
    its plain version: the CPU tests' grid (N 3, 8, 16 x S 1, 37, 130, with
    and without h0, Bc and Cc as strided ``torch.split`` views), the
    exponential's error, then the Mamba serve's admit shapes with the
    control, the peak memory of one call, and times: the kernel, the plain
    version, the route it replaces and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ss
    worst, ctls, n = 0.0, [], 0
    for N in (3, 8, 16):
        for S in (1, 37, 130):
            for with_h0 in (False, True):
                args = _fused_inputs(gen, dev, 2, S, 64, N, with_h0)
                err, ctl = _fused_check(f"fused ssm_scan (2, {S}, 64, {N}) "
                                        f"h0 {with_h0}", args,
                                        control=S > FUSED_STAGE)
                worst, n = max(worst, err), n + 1
                ctls += [ctl] if ctl is not None else []
    print(f"[kernels] ssm_scan fused: {n} checks over (B 2, S 1/37/130, di "
          f"64, N 3/8/16) with and without h0, Bc and Cc strided views "
          f"passed: max |kernel - plain| over y and h_final {worst:.3e} "
          f"(limit atol=rtol={SCAN_TOL}); the controls (carry zeroed every "
          f"{FUSED_STAGE} steps) off by {min(ctls):.3e} to {max(ctls):.3e}, "
          f"each rejected")
    # the exponential alone: x = 0 and h0 = 1 at S = 1 leave h_final = a
    dt = torch.rand(1, 1, 64, device=dev, generator=gen) * 5
    A = -torch.rand(64, 16, device=dev, generator=gen) * 20
    Bc = torch.zeros(1, 1, 16, device=dev)
    _, a = ss.selective_scan_fused(torch.zeros_like(dt), dt, Bc, Bc, A,
                                   torch.zeros(64, device=dev),
                                   torch.ones(1, 64, 16, device=dev))
    want = torch.exp(dt[0, 0, :, None].double() * A.double())
    keep = want > 1e-30
    rel = ((a[0].double() - want).abs() / want)[keep].max().item()
    plain = ((torch.exp(dt[0, 0, :, None] * A).double() - want).abs() /
             want)[keep].max().item()
    check(rel < SCAN_TOL, f"fused ssm_scan: exp off by {rel:.3e} relative")
    print(f"[kernels] ssm_scan fused exp (ex2.approx.ftz.f32 of dt (A "
          f"log2 e)) over dt A in [-100, 0], values above 1e-30: max "
          f"relative error {rel:.3e} against fp64 exp (torch.exp in fp32: "
          f"{plain:.3e})")
    clock = _sm_clock_hz()
    for B, S in _mamba_admits():
        di, N = 8192, 16
        args = _fused_inputs(gen, dev, B, S, di, N)
        err, ctl = _fused_check(f"fused ssm_scan ({B}, {S}, {di}, {N})",
                                args, control=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ss.selective_scan_fused(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        n_el = B * S * di * N
        check(peak < 4 * n_el, f"fused ssm_scan ({B}, {S}): {peak} bytes "
              f"allocated, a (B, S, di, N) fp32 tensor is {4 * n_el}")
        wk = _work()
        w = wk.selective_scan(B, S, di, N)
        t_exp = w.exps / (wk.SFU_PER_CLOCK * wk.H100_SMS * clock) * 1e3
        t_bytes = w.bytes / wk.HBM_BPS * 1e3
        st = _stats(err, w,
                    _time_ms([lambda: ss.selective_scan_fused(*args)],
                             iters=10),
                    _time_ms([lambda: ref.selective_scan_ref(*args)],
                             iters=2), None, clock_hz=clock)
        route_ms = _time_ms([lambda: _composed_route(*args)], iters=2)
        iss = _issue_ms(lambda: ss.selective_scan_fused(*args), iters=10)
        print(f"[kernels] ssm_scan fused ({B}, {S}, {di}, {N}) fp32: "
              f"max_abs_err={err:.3e} (limit atol=rtol={SCAN_TOL}; control "
              f"with the carry zeroed every {FUSED_STAGE} steps: "
              f"{ctl:.3e}) ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} "
              f"the route it replaces (a_bar, b_bar, the scan kernel, "
              f"einsum) ms={route_ms:.4f} bound_ms={st['bound_ms']:.4f} "
              f"(bytes {t_bytes:.4f}, fp32 operations "
              f"{w.flops / wk.PEAK_OPS['float32'] * 1e3:.4f}, exponentials "
              f"{t_exp:.4f} at {wk.SFU_PER_CLOCK} a clock x {wk.H100_SMS} "
              f"SMs x "
              f"{clock / 1e6:.0f} MHz: {'exponentials' if t_exp >= t_bytes else 'bytes'}"
              f" bind); peak allocation of a call {peak / 2**20:.1f} MiB "
              f"(a (B, S, di, N) fp32 tensor: {4 * n_el / 2**20:.1f} MiB); "
              f"issued one by one from Python: {iss:.4f} ms per call; "
              f"library_ms null (no PyTorch call computes the op)")
        if (B, S) == (4, 512):
            stats["ssm_scan_fused"] = dict(st, library_ms=None)
            issue["ssm_scan_fused"] = iss
        del args
    torch.cuda.empty_cache()


def _stats(err, w, ms, plain_ms, library_ms, clock_hz=None):
    """A kernel row: its readings, and its bound from ``w``, the call's
    ``kernels/work.py`` Work (the exponentials bind with ``clock_hz``)."""
    bound, by = w.bound_ms(clock_hz)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound, "bound_by": by}


_WORK = []


def _work():
    """``src/repro_torch/kernels/work.py`` of this checkout, loaded by its
    path: the A/B scripts run chip_smoke's checks against the package of
    another checkout, which may predate it."""
    if not _WORK:
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "chip_smoke_work", ROOT / "src" / "repro_torch" / "kernels" /
            "work.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod        # dataclasses look it up
        spec.loader.exec_module(mod)
        _WORK.append(mod)
    return _WORK[0]


# ----------------------------------------------------------------------
def _drain(eng, prompts, max_new):
    reqs = [eng.submit(p, max_new=max_new) for p in prompts]
    eng.run_until_drained()
    return reqs


PAGED_KERNELS = ("paged_decode_attention", "paged_extend_attention")
DENSE_KERNELS = ("flash_attention", "decode_attention")
SSM_KERNELS = ("ssm_scan",)
MLA_KERNELS = ("mla_decode_attention",)


def _dense_kernels(cfg):
    """The kernels of ``cfg``'s dense path: flash and the split-K decode,
    and the MLA decode where it has MLA layers."""
    return DENSE_KERNELS + (MLA_KERNELS if cfg.kv_lora_rank else ())


def _forced_plain(plain: bool):
    """A context in which every op takes its plain version on the card
    (counted in ``ops.PLAIN_CALLS``), if ``plain``."""
    from repro_torch import kernels
    from repro_torch.kernels import ops

    def plain_route(name, q):
        kernels.count(ops.PLAIN_CALLS, name)
        return "cpu"
    return mock.patch.object(ops, "_route", plain_route) if plain else \
        contextlib.nullcontext()


def _reduced_two_layers(arch, **over):
    """``arch``'s fp32 reduced config, two layers deep (an arch of several
    layer kinds keeps reduced()'s groups: gemma3-4b's ten layers, local
    and global, in two scan groups), with the fields ``over`` replaced,
    and its seeded weights on the card."""
    import torch
    from repro_torch.configs import ScanGroup, get_config, reduced
    from repro_torch.models.weights import init_params
    dev = torch.device("cuda", 0)
    full = get_config(arch)
    cfg = reduced(full)
    if len(full.groups) == 1 and len(full.groups[0].pattern) == 1:
        cfg = cfg.replace(n_layers=2,
                          groups=(ScanGroup(full.groups[0].pattern, 2),))
    cfg = cfg.replace(**over)
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)


def _token_exact_paths(arch, paths=("paged", "dense"), extra=(), **over):
    """fp32, two-layer reduced ``arch`` (fields ``over`` replaced) on the
    paged and the dense engine (``paths``), each through the kernels and
    forced through the plain versions: the same tokens on each path both
    ways, and the same on both paths; ``extra`` adds prompts of those
    lengths after the others.  An
    MoE arch's paths agree on all but the last request, the one admitted
    after a prefix hit: the paged admit extends only its suffix, so the
    experts' capacity sees other rows, and it decodes beside a finished
    slot, whose token-0 row reads the finished sequence's stale cache on
    the dense path and the slot's nulled table row on the paged path, and
    takes capacity on both.  The others are admitted in pairs of equal
    ``max_new`` that finish together.  Returns the runner (``run(scfg, plain)`` -> requests,
    launches, plain calls, engine), the paged tokens and their count."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda", 0)
    cfg, params = _reduced_two_layers(arch, **over)
    rng = np.random.RandomState(0)
    common = rng.randint(0, cfg.vocab, 16).astype(np.int32)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 9, 7, 12, 6)]
    prompts += [np.concatenate([common, rng.randint(0, cfg.vocab, n)])
                .astype(np.int32) for n in (4, 3)]
    prompts += [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
                for n in extra]

    def run(scfg, plain):
        ops.reset_counts()
        with _forced_plain(plain):
            eng = Engine(params, cfg, scfg, device=dev)
            reqs = _drain(eng, prompts, 6)
        return reqs, dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS), eng

    tokens, used = {}, {}
    for label, keys, scfg in (
            ("paged", PAGED_KERNELS, ServeConfig(
                max_len=64, slots=2, sync_every=4, paged=True,
                block_size=8)),
            ("dense", _dense_kernels(cfg), ServeConfig(max_len=64, slots=2,
                                                       sync_every=4))):
        if label not in paths:
            continue
        kern, k_launch, k_plain, _ = run(scfg, plain=False)
        check(all(k_launch[k] > 0 for k in keys) and
              sum(k_launch.values()) == sum(k_launch[k] for k in keys) and
              not any(k_plain.values()),
              f"{arch} {label} kernel run: launches {k_launch}, plain "
              f"{k_plain}")
        plain, p_launch, p_plain, _ = run(scfg, plain=True)
        check(all(p_plain[k] > 0 for k in keys) and
              not any(p_launch.values()),
              f"{arch} {label} plain run: launches {p_launch}, plain "
              f"{p_plain}")
        for i, (a, b) in enumerate(zip(kern, plain)):
            check(a.out_tokens == b.out_tokens and
                  a.finish_reason == b.finish_reason,
                  f"{arch} {label} request {i}: kernel {a.out_tokens} "
                  f"({a.finish_reason}) != plain {b.out_tokens} "
                  f"({b.finish_reason})")
        tokens[label] = [(r.out_tokens, r.finish_reason) for r in kern]
        used[label] = {k: k_launch[k] for k in keys}
    coupled = any(k == "M" for g in cfg.groups for k in g.pattern)
    agree = len(prompts) - 1 if coupled else len(prompts)
    if len(paths) == 2:
        check(tokens["dense"][:agree] == tokens["paged"][:agree],
              f"{arch}: dense tokens {tokens['dense'][:agree]} != paged "
              f"{tokens['paged'][:agree]}")
    n_tok = sum(len(t) for t, _ in tokens[paths[-1]])
    if len(paths) == 1:
        between = f"(the {paths[0]} path alone)"
    elif not coupled:
        between = "and between the two paths"
    else:
        between = (f"and on the first {agree} requests between the two "
                   f"paths (the last, after a prefix hit: paged == dense "
                   f"{tokens['dense'][-1] == tokens['paged'][-1]}, not a "
                   f"gate)")
    window = f", window {cfg.window}" if cfg.window else ""
    mla = (f", MLA rank {cfg.kv_lora_rank} rope {cfg.rope_head_dim} (q/k "
           f"{cfg.nope_head_dim + cfg.rope_head_dim}, v {cfg.v_head_dim}), "
           f"{cfg.n_shared_experts} shared experts" if cfg.kv_lora_rank
           else "")
    print(f"[token-exact] {arch} fp32 {cfg.n_layers}-layer reduced (H "
          f"{cfg.n_heads}, KV {cfg.n_kv_heads}, hd {cfg.head_dim}{window}"
          f"{mla}, "
          f"{cfg.norm}, {cfg.mlp}, {cfg.family}): {len(prompts)} requests "
          f"of {[len(p) for p in prompts]} tokens, {n_tok} tokens identical "
          f"through the kernels and the plain versions on " +
          " and ".join(f"the {p} path ({used[p]})" for p in paths) +
          f", {between}")
    return run, tokens.get("paged"), n_tok


def phase_token_exact():
    """fp32, two-layer reduced configs: on each path the kernels give the
    plain versions' tokens, and the dense path the paged path's; for
    internlm2-1.8b also the speculative paged engine, for falcon-mamba-7b
    the scan."""
    from repro_torch.serving import ServeConfig
    run, paged_tokens, n_tok = _token_exact_paths("internlm2-1.8b")
    _token_exact_paths("starcoder2-3b")
    _token_exact_paths("internvl2-1b")
    _token_exact_gemma()
    _token_exact_moe()
    # speculative decode: every verify window runs the paged extend, and
    # greedy tokens are the non-speculative ones on either route
    spec = ServeConfig(max_len=64, slots=2, sync_every=4, paged=True,
                       block_size=8, speculative=True)
    for plain in (False, True):
        reqs, launch, calls, _ = run(spec, plain)
        used, unused = (calls, launch) if plain else (launch, calls)
        label = "plain" if plain else "kernel"
        check(used["paged_extend_attention"] > 0 and
              sum(used.values()) == used["paged_extend_attention"] and
              not any(unused.values()),
              f"speculative {label} run: launches {launch}, plain {calls}")
        got = [(r.out_tokens, r.finish_reason) for r in reqs]
        check(got == paged_tokens,
              f"speculative {label} tokens {got} != paged {paged_tokens}")
        if not plain:
            n_ext = launch["paged_extend_attention"]
    print(f"[token-exact] fp32 2-layer reduced, paged speculative (d=3): "
          f"the same {n_tok} tokens through the kernels ({n_ext} paged "
          f"extend launches, no paged decode) and the plain versions")
    _token_exact_mamba()
    _token_exact_recurrentgemma()
    _token_exact_deepseek()
    _token_exact_whisper()


def _token_exact_gemma():
    """fp32 reduced gemma-7b (two layers, GeGLU, MHA) paged and dense, and
    gemma3-4b (its ten local and global layers, window 16) dense, each
    kernel against plain, at the reduced head dim 16 and at 256, so that
    the fp32 kernels run at hd 256 on a real path.  gemma3's prompts of
    19, 20 and 40 tokens pass its window, so flash's window mask and the
    local layers' rings wrap in the prefill, and decoding past 16
    positions wraps them in the decode; with 2 slots, later requests reuse
    the slots of longer ones."""
    for hd in (16, 256):
        _token_exact_paths("gemma-7b", head_dim=hd)
        _token_exact_paths("gemma3-4b", paths=("dense",), extra=(40,),
                           head_dim=hd)


def _token_exact_moe():
    """fp32, two-layer reduced qwen3-moe-30b-a3b (8 experts, top-2, qk-norm)
    paged and dense, kernel against plain, with every admit batch-1; then
    the paged engine with ``speculative=True``: it falls back (counted
    once) and gives the paged tokens through the kernels."""
    from repro_torch.cluster import tracing
    from repro_torch.serving import ServeConfig
    arch = "qwen3-moe-30b-a3b"
    seq0 = tracing.current_recorder().last_seq
    run, paged_tokens, n_tok = _token_exact_paths(arch)
    admits = [e["n"] for e in tracing.current_recorder().events()
              if e["seq"] > seq0 and e["kind"] == "admit"]
    check(admits and set(admits) == {1},
          f"{arch}: admit batches {admits}, expected all batch-1")
    spec = ServeConfig(max_len=64, slots=2, sync_every=4, paged=True,
                       block_size=8, speculative=True)
    reqs, launch, calls, eng = run(spec, False)
    got = [(r.out_tokens, r.finish_reason) for r in reqs]
    fallback = eng.metrics.counter("engine.spec_fallback").value
    check(eng.paged and not eng.speculative and fallback == 1 and
          launch["paged_decode_attention"] > 0 and not any(calls.values()),
          f"{arch} speculative: paged {eng.paged}, speculative "
          f"{eng.speculative}, spec_fallback {fallback}, launches {launch}, "
          f"plain {calls}")
    check(got == paged_tokens,
          f"{arch} speculative tokens {got} != paged {paged_tokens}")
    print(f"[token-exact] {arch} with speculative=True: falls back to "
          f"paged decode (engine.speculative False, spec_fallback "
          f"{fallback}), the same {n_tok} tokens; {len(admits)} admits, "
          f"all batch-1")
    _moe_never_syncs(arch)


def _moe_never_syncs(arch):
    """One MoE FFN call at an 8-slot decode's shape with CUDA's sync
    debug mode set to error: the router, the dispatch, the combine and the
    shared experts, where the arch has them, read nothing back to the
    host, so a decode step stays capturable."""
    import torch
    from repro_torch.models import moe
    cfg, params = _reduced_two_layers(arch)
    gi = next(i for i, g in enumerate(cfg.groups) if "M" in g.pattern)
    ffn = {k: (v[0] if torch.is_tensor(v) else {n: t[0] for n, t in
                                                  v.items()})
           for k, v in params["groups"][gi][0]["ffn"].items()}
    x = torch.randn(8, 1, cfg.d_model, device=torch.device("cuda", 0))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, aux = moe.apply_moe(ffn, x, cfg)
    except RuntimeError as e:
        fail(f"apply_moe synchronised with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(bool(torch.isfinite(out).all()) and bool(torch.isfinite(aux)),
          "apply_moe gave non-finite values")
    shared = f" with {cfg.n_shared_experts} shared experts" if \
        cfg.n_shared_experts else ""
    print(f"[token-exact] {arch} apply_moe{shared} at (8, 1, {cfg.d_model}) "
          f"under torch.cuda.set_sync_debug_mode('error'): no synchronising "
          f"op detected")


def _token_exact_mamba():
    """fp32, two-layer reduced falcon-mamba-7b on the dense engine: the
    scan kernel gives the plain version's tokens, on prompts of 130 tokens
    (at and past the JAX kernel gate, S >= 128) and of 100 (not a
    multiple of the TPU kernel's 64-step chunk)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda", 0)
    cfg, params = _reduced_two_layers("falcon-mamba-7b")
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (130, 5, 100, 9, 7, 7)]
    scfg = ServeConfig(max_len=256, slots=2, sync_every=4)
    runs = {}
    for label, plain in (("kernel", False), ("plain", True)):
        ops.reset_counts()
        with _forced_plain(plain):
            eng = Engine(params, cfg, scfg, device=dev)
            reqs = _drain(eng, prompts, 6)
        launches, calls = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
        batches = eng.metrics.counter("engine.prefill_batches").value
        used, unused = (calls, launches) if plain else (launches, calls)
        check(used["ssm_scan"] == 2 * batches and
              sum(used.values()) == used["ssm_scan"] and
              not any(unused.values()),
              f"mamba {label} run: launches {launches}, plain {calls}, "
              f"prefill batches {batches}")
        runs[label] = [(r.out_tokens, r.finish_reason) for r in reqs]
        if not plain:
            n_launch = launches["ssm_scan"]
    check(runs["kernel"] == runs["plain"],
          f"mamba: kernel tokens {runs['kernel']} != plain {runs['plain']}")
    print(f"[token-exact] fp32 2-layer reduced falcon-mamba-7b, dense "
          f"engine: {len(prompts)} requests of "
          f"{[len(p) for p in prompts]} tokens, "
          f"{sum(len(t) for t, _ in runs['kernel'])} tokens identical "
          f"through the scan kernel ({n_launch} launches in "
          f"{batches} prefill batches) and the plain version")


def _token_exact_recurrentgemma():
    """fp32 reduced recurrentgemma-2b with its first scan group at 2
    repeats, ``(R, R, L) x 2 + (R, R) x 1`` (6 RG-LRU and 2 local layers,
    R > 1 for both kinds; MQA, hd 16, window 16), max_len 48, on the dense
    engine through the kernels and forced through the plain versions: the
    same tokens, with flash 2 and ``ssm_scan`` 6 a prefill batch and the
    split-K decode 2 a step.  Prompts of 1, 2 and 3 tokens (shorter than
    the conv's K-1 = 3, or equal) and past the window, same lengths
    adjacent; then the paged engine asked for once: it serves dense, with
    the same tokens and the fallback counted."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import ScanGroup, get_config, reduced
    from repro_torch.kernels import ops
    from repro_torch.models.weights import init_params
    from repro_torch.serving import Engine, ServeConfig
    dev = torch.device("cuda", 0)
    arch = RG_HEADS[0]
    cfg = reduced(get_config(arch)).replace(
        n_layers=8, groups=(ScanGroup(("R", "R", "L"), 2),
                            ScanGroup(("R", "R"), 1)))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab, size=n).astype(np.int32)
               for n in (20, 20, 1, 2, 3, 3, 25, 1, 40)]
    n_attn = sum(k == "L" for g in cfg.groups for k in g.pattern * g.repeats)
    n_scan = cfg.n_layers - n_attn
    runs = {}
    for label, plain, extra in (("kernel", False, {}), ("plain", True, {}),
                                ("paged asked", False,
                                 dict(paged=True, block_size=8))):
        ops.reset_counts()
        with _forced_plain(plain):
            eng = Engine(params, cfg, ServeConfig(max_len=48, slots=2,
                                                  sync_every=4, **extra),
                         device=dev)
            reqs = _drain(eng, prompts, 8)
        launches, calls = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
        batches = eng.metrics.counter("engine.prefill_batches").value
        fallback = eng.metrics.counter("engine.paged_fallback_dense").value
        used, unused = (calls, launches) if plain else (launches, calls)
        check(used["flash_attention"] == n_attn * batches and
              used["ssm_scan"] == n_scan * batches and
              used["decode_attention"] > 0 and
              used["decode_attention"] % n_attn == 0 and
              sum(used.values()) == sum(used[k] for k in
                                        DENSE_KERNELS + SSM_KERNELS) and
              not any(unused.values()) and not eng.paged and
              fallback == int("paged" in extra),
              f"{arch} {label} run: launches {launches}, plain {calls}, "
              f"prefill batches {batches}, paged {eng.paged}, "
              f"paged_fallback_dense {fallback}")
        runs[label] = [(r.out_tokens, r.finish_reason) for r in reqs]
        if label == "kernel":
            counts = {k: launches[k] for k in DENSE_KERNELS + SSM_KERNELS}
    for label in ("plain", "paged asked"):
        check(runs[label] == runs["kernel"],
              f"{arch}: {label} tokens {runs[label]} != kernel "
              f"{runs['kernel']}")
    print(f"[token-exact] {arch} fp32 {cfg.n_layers}-layer reduced ((R, R, "
          f"L) x 2 + (R, R); H {cfg.n_heads}, KV {cfg.n_kv_heads}, hd "
          f"{cfg.head_dim}, window {cfg.window}, lru_width "
          f"{cfg.lru_width}), dense engine, max_len 48: {len(prompts)} "
          f"requests of {[len(p) for p in prompts]} tokens, "
          f"{sum(len(t) for t, _ in runs['kernel'])} tokens identical "
          f"through the kernels ({counts} in {batches} prefill batches) and "
          f"the plain versions, and asked for the paged engine (served "
          f"dense, paged_fallback_dense 1)")


def _token_exact_deepseek():
    """fp32 reduced deepseek-v2-lite-16b, its dense first layer and 2 MLA
    layers (``D`` x 1 + ``M`` x 2: R > 1; MLA rank 32, rope 8, q/k 24, v
    16; 8 experts top-2 and 2 shared experts), on the dense engine through
    the kernels (flash at (24, 16) and hd 16, the split-K decode, the MLA
    decode at (32, 8)) and forced through the plain versions: the same
    tokens, every admit batch-1; then asked for the paged engine (served
    dense, the fallback counted) and with ``speculative=True`` (off,
    counted): the same tokens; and one MoE-with-shared-experts FFN call
    under sync debug ``error``."""
    from repro_torch.cluster import tracing
    from repro_torch.configs import ScanGroup
    from repro_torch.serving import ServeConfig
    arch = DS_ARCH
    seq0 = tracing.current_recorder().last_seq
    run, _, n_tok = _token_exact_paths(
        arch, paths=("dense",), n_layers=3,
        groups=(ScanGroup(("D",), 1), ScanGroup(("M",), 2)))
    admits = [e["n"] for e in tracing.current_recorder().events()
              if e["seq"] > seq0 and e["kind"] == "admit"]
    check(admits and set(admits) == {1},
          f"{arch}: admit batches {admits}, expected all batch-1")
    base, _, _, _ = run(ServeConfig(max_len=64, slots=2, sync_every=4),
                        False)
    want = [(r.out_tokens, r.finish_reason) for r in base]
    for label, extra, counter in (
            ("paged asked", dict(paged=True, block_size=8),
             "engine.paged_fallback_dense"),
            ("speculative asked", dict(paged=True, block_size=8,
                                       speculative=True),
             "engine.spec_fallback")):
        reqs, launch, calls, eng = run(ServeConfig(
            max_len=64, slots=2, sync_every=4, **extra), False)
        got = [(r.out_tokens, r.finish_reason) for r in reqs]
        fallback = eng.metrics.counter(counter).value
        check(not eng.paged and not eng.speculative and fallback == 1 and
              launch["mla_decode_attention"] > 0 and
              not any(launch[k] for k in PAGED_KERNELS) and
              not any(calls.values()) and got == want,
              f"{arch} {label}: paged {eng.paged}, speculative "
              f"{eng.speculative}, {counter} {fallback}, launches {launch}, "
              f"plain {calls}, tokens {got} against {want}")
    print(f"[token-exact] {arch} asked for the paged engine and for "
          f"speculative decode: served dense (paged_fallback_dense 1, "
          f"spec_fallback 1), the same {n_tok} tokens; {len(admits)} admits, "
          f"all batch-1")
    _moe_never_syncs(arch)


# ----------------------------------------------------------------------
def phase_serve():
    """internlm2-1.8b at full width through the paged path, then through
    the dense path, then starcoder2-3b (G 12), internvl2-1b (G 7, hd 64)
    and gemma-7b (G 1, hd 256) the same two ways, gemma3-4b (G 2, hd 256)
    and recurrentgemma-2b (G 10, hd 256, RG-LRU) asked for the paged
    engine (they serve dense), falcon-mamba-7b, and
    qwen3-moe-30b-a3b (G 8, 128 experts) both ways; returns each kernel's
    launches in internlm2's run of its path (the scan kernel's in
    recurrentgemma-2b's, the fused scan's in falcon-mamba-7b's), and the
    paged run's tokens."""
    launches, paged_tokens = _serve_path(True)
    launches.update(_serve_path(False)[0])
    # one profiled decode sync an arch past internlm2-1.8b: the dense
    # engine's (each arch's paged and dense syncs were within 7% of each
    # other in device busy, and each profile's trace takes ~35 s)
    for arch in ("starcoder2-3b", "internvl2-1b", "gemma-7b"):
        for paged in (True, False):
            _serve_path(paged, arch, profile=not paged)
    # gemma3-4b's rings cannot page: asked for the paged engine, it serves
    # dense, counted in engine.paged_fallback_dense
    _serve_path(True, "gemma3-4b")
    # nor can recurrentgemma-2b's RG-LRU state and rings (max_len 4096);
    # its RG-LRU recurrence is the scan kernel's path, Mamba's op the fused
    # kernel's (both count under ssm_scan; the profiles name each kernel)
    launches["ssm_scan"] = _serve_path(True, "recurrentgemma-2b")[0][
        "ssm_scan"]
    launches["ssm_scan_fused"] = _serve_mamba()["ssm_scan"]
    # 57 GiB of weights: served last, each engine alone on the card; only
    # the paged one's decode sync is profiled (the two profiles took ~70 s
    # each for the same expert products, and the run needs the time)
    for paged in (True, False):
        _serve_path(paged, "qwen3-moe-30b-a3b", profile=paged)
    # then deepseek-v2-lite-16b (29 GiB) alone: MLA's latent cache cannot
    # page, so asked for the paged engine it serves dense, counted
    launches.update({k: v for k, v in _serve_path(True, DS_ARCH)[0].items()
                     if k in MLA_KERNELS})
    return launches, paged_tokens


#: phase 4's ninth request, by arch: gemma3-4b's prompt past its 1,024-key
#: window, so that flash's window bites at full width and the local
#: layers' rings wrap in the prefill and in the decode
SERVE_LONG = {"gemma3-4b": 1100, "recurrentgemma-2b": 2200}

#: phase 4's max_len, by arch (2048 for the others): recurrentgemma-2b's
#: local layers keep rings only where the window (2048) is shorter
SERVE_MAX_LEN = {"recurrentgemma-2b": 4096}


def _serve_prompts(vocab, long=0):
    """Phase 4's requests, drawn from one seeded stream: ``tok(n)`` draws
    n more tokens; a warm-up prompt, then 8 prompts of 16-512 tokens, two
    sharing a 256-token prefix, and with ``long`` a ninth of ``long``
    tokens.  A request of another bucket sits between those two, so the
    second is admitted after the first published the prefix."""
    import numpy as np
    rng = np.random.RandomState(1)
    tok = lambda n: rng.randint(0, vocab, n).astype(np.int32)  # noqa
    warm = tok(40)
    prefix = tok(256)
    prompts = [np.concatenate([prefix, tok(44)]), tok(16),
               np.concatenate([prefix, tok(100)]), tok(64), tok(512),
               tok(200), tok(33), tok(128)]
    if long:
        prompts.append(tok(long))
    return tok, warm, prompts


def _serve_path(paged: bool, arch: str = "internlm2-1.8b",
                profile: bool = True):
    """``arch`` at full width (bf16, seeded weights) through the paged or
    the dense engine at phase 4's settings: the requests, the path's
    launch counts read right after them (one a layer per admit batch and
    per decode step, no other kernel, no plain call; an MoE arch's admits
    all batch-1; a recurrent layer's scan once per admit batch), then one
    profiled decode sync (and for an RG-LRU arch its long admit); returns
    (launches, tokens).  An arch that cannot page (gemma3-4b's rings,
    recurrentgemma-2b's state) asked for the paged engine must serve dense
    and count the fallback once.  max_len is 2048, or the arch's
    SERVE_MAX_LEN.  ``profile=False`` skips the profiled decode sync."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.cluster import tracing
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import transformer as tfm
    dev = torch.device("cuda", 0)
    max_len = SERVE_MAX_LEN.get(arch, 2048)
    asked, paged = paged, paged and tfm.paged_supported(get_config(arch),
                                                         max_len)
    label = "paged" if paged else "dense"
    if asked and not paged:
        label = "dense fallback"
    if arch != "internlm2-1.8b":
        label = f"{arch} {label}"
    # layers of a recurrent kind (RG-LRU) scan their admits on the scan
    # kernel; the others run attention
    full = get_config(arch)
    n_scan = sum(k in ("R", "S") for g in full.groups
                 for k in g.pattern * g.repeats)
    # MLA layers decode on the MLA decode kernel, the others on split-K
    n_mla = sum(k == "M" for g in full.groups
                for k in g.pattern * g.repeats) if full.kv_lora_rank else 0
    keys = (PAGED_KERNELS if paged else _dense_kernels(full)) + \
        (SSM_KERNELS if n_scan else ())
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated(dev) < 2**30,
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
          f"allocated before the {label} serve")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = build_engine(arch, max_len=max_len, slots=8, sync_every=8,
                       paged=asked, block_size=16, seed=0, device=dev)
    torch.cuda.synchronize()
    init_mem = torch.cuda.memory_allocated(dev)
    cfg = eng.cfg
    n_params = sum(t.numel() for t in _leaves(eng.params))
    fallback = eng.metrics.counter("engine.paged_fallback_dense").value
    fp32 = sorted({k for g in eng.params["groups"] for layer in g
                   for k, t in layer["mixer"].items()
                   if t.dtype == torch.float32})
    check(cfg == get_config(arch) and
          eng.params["embedding"]["table"].dtype == torch.bfloat16 and
          fp32 == (["lambda"] if cfg.lru_width else []) and
          eng.paged == paged and fallback == int(asked and not paged),
          f"{arch}: not the full-width bf16 config on the {label} engine "
          f"(engine.paged {eng.paged}, paged_fallback_dense {fallback}, "
          f"fp32 mixer leaves {fp32})")
    rings = sorted({c["k"].shape[2] for g in eng.caches for c in g
                    if "pos" in c}) if not paged else []
    kv = (f"pool {eng.alloc.num_blocks} blocks x 16" if paged else
          f"dense caches 8 x {max_len}" +
          (f", local layers' rings of {rings} rows" if rings else "") +
          (f", {n_scan} RG-LRU layers' fp32 state, lambda fp32"
           if cfg.lru_width else "") +
          (f", {n_mla} MLA layers' latent caches 8 x {max_len} x "
           f"({cfg.kv_lora_rank} + {cfg.rope_head_dim})" if n_mla else "") +
          (f", paged_fallback_dense {fallback}" if asked else ""))
    ffn = (f"{cfg.n_experts} experts top-{cfg.top_k}, expert d_ff "
           f"{cfg.expert_d_ff}" if cfg.n_experts else f"d_ff {cfg.d_ff}")
    if cfg.n_shared_experts:
        ffn += (f", {cfg.n_shared_experts} shared experts of d_ff "
                f"{cfg.shared_d_ff}")
    if n_mla:
        ffn += (f", MLA q/k {cfg.nope_head_dim + cfg.rope_head_dim} v "
                f"{cfg.v_head_dim} rank {cfg.kv_lora_rank}, a dense first "
                f"layer of d_ff {cfg.dense_d_ff}")
    print(f"[serve {label}] built {arch} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv "
          f"heads, hd {cfg.head_dim}, {ffn}, {cfg.norm}, {cfg.mlp}, "
          f"qk_norm {cfg.qk_norm}, vocab {cfg.vocab}, tied "
          f"{cfg.tie_embeddings}, {n_params / 1e9:.3f} B parameters, bf16, "
          f"{kv}) in {time.perf_counter() - t0:.1f}s; device memory "
          f"{init_mem / 2**30:.2f} GiB, peak during "
          f"the init {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    tok, warm, prompts = _serve_prompts(cfg.vocab, SERVE_LONG.get(arch, 0))
    # warm-up request (cuBLAS handles, allocator), then the measured run
    _drain(eng, [warm], 8)
    max_new = 32
    counter = lambda name: eng.metrics.counter(name).value  # noqa: E731
    hits0, syncs0, batches0 = (counter(f"engine.{k}") for k in (
        "prefix_hit_blocks", "steps", "prefill_batches"))
    seq0 = tracing.current_recorder().last_seq
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    hits = counter("engine.prefix_hit_blocks") - hits0
    syncs = counter("engine.steps") - syncs0
    batches = counter("engine.prefill_batches") - batches0
    admits = [(e["n"], e["bucket"]) for e in tracing.current_recorder()
              .events() if e["seq"] > seq0 and e["kind"] == "admit"]
    shapes = [(1, S) for S, _ in _admit_shapes(arch, paged)]
    check(admits == shapes,
          f"{label}: admits (n, bucket) {admits}, expected {shapes}, the "
          f"shapes phase 2 held the kernels to")
    admits = [n for n, _ in admits]
    for r in reqs:
        check(r.finish_reason == "max_new" and
              len(r.out_tokens) == max_new + 1 and
              all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: {r.finish_reason}, {r.out_tokens}")
    # one launch an attention layer for each admit batch (extend or flash)
    # and for each of the 8 decode steps of a sync (paged or split-K
    # decode), one a recurrent layer for each admit batch (the scan)
    n_attn = cfg.n_layers - n_scan
    want = {keys[0 if paged else 1]: (n_attn - n_mla) * 8 * syncs,
            keys[1 if paged else 0]: n_attn * batches}
    if n_scan:
        want["ssm_scan"] = n_scan * batches
    if n_mla:
        want["mla_decode_attention"] = n_mla * 8 * syncs
    check(all(launches[k] == want[k] for k in keys) and
          sum(launches.values()) == sum(launches[k] for k in keys),
          f"{label}: launches {launches}, expected {want} ({syncs} syncs, "
          f"{batches} admit batches) and no other kernel")
    check(not any(plain.values()), f"{label}: plain versions ran: {plain}")
    check(len(admits) == batches and sum(admits) == len(reqs),
          f"{label}: admit events {admits} against {batches} admit batches")
    if eng.fns.row_coupled:
        check(set(admits) == {1}, f"{label}: MoE admits {admits} are not "
              f"all batch-1")
    if paged:
        check(hits >= 16, f"prefix cache hit {hits} blocks, expected >= 16")
        check(eng.alloc.free_blocks + eng.alloc.cached_blocks ==
              eng.alloc.num_blocks, "blocks leaked")
    gen = sum(r.decoded for r in reqs)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    print(f"[serve {label}] {arch} {len(reqs)} requests "
          f"({sum(len(p) for p in prompts)} prompt tokens) max_new={max_new}"
          f": wall={wall:.3f}s decoded={gen} tok/s={gen / wall:.1f} "
          f"ttft_p50={ttft[len(ttft) // 2]:.3f}s ttft_max={ttft[-1]:.3f}s "
          f"prefix_hit_blocks={hits} "
          f"launches={launches} (= {n_attn - n_mla} attention layers x "
          f"{syncs} syncs x 8 steps, x {batches} admit batches" +
          (f"; {n_mla} MLA layers x {syncs} syncs x 8 steps on the MLA "
           f"decode, and in each admit batch's flash" if n_mla else "") +
          (f"; {n_scan} RG-LRU layers x {batches} admit batches"
           if n_scan else "") + f") plain_calls={plain} "
          f"admit batch sizes={admits} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GiB")
    if profile:
        _profile_decode_sync(eng, tok, label)
    if cfg.lru_width:
        _profile_long_admit(eng, tok, label)
    tokens = [r.out_tokens for r in reqs]
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches[k] for k in keys}, tokens


def _leaves(tree):
    """The tensors of a nested parameter tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _serve_mamba():
    """falcon-mamba-7b at full width on the dense engine, after the
    internlm2 engines are freed; returns the scan's launches in the run."""
    import gc

    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.cluster import tracing
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine
    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    check(torch.cuda.memory_allocated(dev) < 2**30,
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB still "
          f"allocated before the Mamba serve")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    eng = build_engine("falcon-mamba-7b", max_len=2048, slots=8,
                       sync_every=8, seed=0, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, mixer = eng.cfg, eng.params["groups"][0][0]["mixer"]
    check(cfg.n_layers == 64 and cfg.d_model == 4096 and
          cfg.d_inner == 8192 and cfg.ssm_state == 16 and
          cfg.dt_rank == 256 and cfg.conv_k == 4 and cfg.vocab == 65024 and
          cfg.tie_embeddings and "lm_head" not in eng.params and
          mixer["in_proj"].shape == (64, 4096, 16384) and
          mixer["in_proj"].dtype == torch.bfloat16 and
          mixer["A_log"].dtype == torch.float32 and not eng.paged,
          "not the full-width bf16 falcon-mamba-7b on the dense engine")
    print(f"[serve mamba] built falcon-mamba-7b (64 layers, d_model 4096, "
          f"d_inner 8192, state 16, bf16, dense state 8 slots) in "
          f"{build_s:.1f}s; device memory "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB, peak during "
          f"the init {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    rng = np.random.RandomState(1)
    tok = lambda n: rng.randint(0, cfg.vocab, n).astype(np.int32)  # noqa
    _drain(eng, [tok(40)], 8)           # warm-up (cuBLAS, allocator)
    # same lengths adjacent, so each group shares one exact-length admit
    prompts = [tok(n) for n in MAMBA_PROMPTS]
    max_new = 32
    b0 = eng.metrics.counter("engine.prefill_batches").value
    seq0 = tracing.current_recorder().last_seq
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    batches = eng.metrics.counter("engine.prefill_batches").value - b0
    admits = [(e["n"], e["bucket"]) for e in tracing.current_recorder()
              .events() if e["seq"] > seq0 and e["kind"] == "admit"]
    check(admits == _mamba_admits(),
          f"mamba: admits (n, S) {admits}, expected {_mamba_admits()}, the "
          f"shapes phase 2 held the scan kernels to")
    for r in reqs:
        check(r.finish_reason == "max_new" and
              len(r.out_tokens) == max_new + 1 and
              all(0 <= t < cfg.vocab for t in r.out_tokens),
              f"request {r.rid}: {r.finish_reason}, {r.out_tokens}")
    check(batches == len(admits) and launches["ssm_scan"] == 64 * batches
          and sum(launches.values()) == launches["ssm_scan"],
          f"mamba: launches {launches} in {batches} prefill batches, "
          f"expected ssm_scan = 64 x {len(admits)} and no other kernel")
    check(not any(plain.values()), f"plain versions ran: {plain}")
    gen = sum(r.decoded for r in reqs)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    print(f"[serve mamba] falcon-mamba-7b {len(reqs)} requests "
          f"({sum(len(p) for p in prompts)} prompt tokens) max_new={max_new}"
          f": wall={wall:.3f}s decoded={gen} tok/s={gen / wall:.1f} "
          f"ttft_max={ttft[-1]:.3f}s launches={launches} plain_calls={plain} "
          f"prefill_batches={batches} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GiB")
    _profile_decode_sync(eng, tok, "mamba")
    _profile_admit(eng, tok)
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return {"ssm_scan": launches["ssm_scan"]}


def _scan_kernels(rows):
    """The names of the scan kernels among a profile's rows."""
    return sorted({re.search(r"ssm_scan\w*kernel", name)[0]
                   for _, _, name in rows if "ssm_scan" in name})


def _profile_admit(eng, tok):
    """One admit of 4 x 512 tokens (64 layers) on the host clock, then the
    next one under ``torch.profiler`` with the device memory before it and
    its peak: the scan's device time against what runs around it in
    torch; then the same admit on the route the fused kernel replaced
    (``ops.ssm_scan`` patched to a_bar, b_bar, the scan kernel and einsum),
    profiled the same way: the broadcast multiplies that build a_bar and
    b_bar, the exp of a_bar, the C contraction (a batched GEMV)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    dev = eng.device

    def submit_and_admit():
        for _ in range(4):
            eng.submit(tok(512), max_new=1)
        eng._admit_fused()
        torch.cuda.synchronize()

    def admit():
        submit_and_admit()
        eng.run_until_drained()

    busy = {}
    for route, patch in (("fused", contextlib.nullcontext()),
                         ("composed", mock.patch.object(
                             ops, "ssm_scan", _composed_route))):
        with patch:
            admit()
            t0 = time.perf_counter()
            admit()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                submit_and_admit()
                wall_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated(dev)
            eng.run_until_drained()
        busy_us, rows, top = _device_time(prof, f"mamba_admit_{route}")
        want = ["ssm_scan_fused_kernel"] if route == "fused" else \
            ["ssm_scan_kernel"]
        check(_scan_kernels(rows) == want, f"mamba {route} admit: scan "
              f"kernels {_scan_kernels(rows)}, expected {want}")
        share = dict.fromkeys(("scan", "mul", "exp", "gemv", "gemm",
                               "other"), 0.0)
        for us, _, name in rows:
            low = name.lower()
            kind = ("scan" if "ssm_scan" in low else
                    "mul" if "mulfunctor<float> > >" in low and
                    "binaryfunctor<float" in low else
                    "exp" if "exp_kernel" in low else
                    "gemv" if "gemv" in low else
                    "gemm" if any(k in low for k in ("nvjet", "gemm",
                                                     "cutlass", "xmma")) else
                    "other")
            share[kind] += us / 1e3
        busy[route] = busy_us / 1e3
        what = ("the fused kernel" if route == "fused" else
                "the route it replaced: a_bar, b_bar, the scan kernel, "
                "einsum")
        print(f"[profile mamba admit] {what}: one admit of 4 x 512 tokens "
              f"(64 layers): unprofiled wall {host_ms:.2f}ms with its "
              f"one-token drain; profiled admit wall={wall_ms:.2f}ms "
              f"device_busy={busy_us / 1e3:.2f}ms idle_share="
              f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
              f"{sum(n for _, n, _ in rows)}; device memory before "
              f"{before / 2**30:.2f} GiB, peak during the admit "
              f"{peak / 2**30:.2f} GiB (+{(peak - before) / 2**30:.2f}); "
              f"device ms by kind: " +
              ", ".join(f"{k} {v:.2f}" for k, v in share.items()) +
              f"; top: {top}")
    print(f"[profile mamba admit] device busy fused / replaced route: "
          f"{busy['fused']:.2f} / {busy['composed']:.2f} ms "
          f"({busy['fused'] / busy['composed']:.3f}x)")


def _kind_ms(rows):
    """Device ms of a profile's kernel rows by kind: the scan kernel,
    flash, the decode attention kernels, fp32 GEMMs (the RG-LRU gate
    products: cuBLAS's fp32 kernels, TF32 off; a CUDA-core ``sgemm`` at
    an admit, a ``gemvx`` over floats at a decode step), the other GEMMs
    (bf16), copies (the casts, among them the gates' fp32 copies of
    ``w_a`` and ``w_i``) and the rest."""
    kinds = dict.fromkeys(("scan", "flash", "decode attention",
                           "fp32 GEMMs", "bf16 GEMMs", "copies/casts",
                           "other"), 0.0)
    for us, _, name in rows:
        low = name.lower()
        gemm = any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma",
                                      "gemv"))
        fp32 = any(k in low for k in ("sgemm", "f32f32_f32f32", "nvjet_sss",
                                      "kernel<int, int, float,"))
        kind = ("scan" if "ssm_scan" in low else
                "flash" if "flash" in low or "attention_sm90" in low else
                "decode attention" if "decode" in low else
                "fp32 GEMMs" if gemm and fp32 else
                "bf16 GEMMs" if gemm else
                "copies/casts" if "copy" in low else "other")
        kinds[kind] += us / 1e3
    return kinds


def _profile_long_admit(eng, tok, label):
    """The serve's long admit (one prompt of SERVE_LONG tokens, past the
    2,048-key window) on the host clock, then the next one under
    ``torch.profiler``: device ms by kind (:func:`_kind_ms`); then the
    RG-LRU gates of one layer alone (``rglru._gates``: the two fp32
    products with their fp32 copies of ``w_a`` and ``w_i``) at the
    admit's and a decode step's shapes, device ms from a CUDA graph, and
    the bytes those copies move."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import rglru
    S = SERVE_LONG[RG_HEADS[0]]

    def admit():
        eng.submit(tok(S), max_new=1)
        eng._admit_fused()
        torch.cuda.synchronize()

    admit()
    eng.run_until_drained()
    t0 = time.perf_counter()
    admit()
    host_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        admit()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    busy_us, rows, top = _device_time(prof, f"{label} long admit")
    check(_scan_kernels(rows) == ["ssm_scan_chunked_kernel"],
          f"{label} long admit: scan kernels {_scan_kernels(rows)}, "
          f"expected the chunked scan")
    print(f"[profile {label} admit] one admit of {S} tokens (batch 1): "
          f"unprofiled wall {host_ms:.2f}ms; profiled wall={wall_ms:.2f}ms "
          f"device_busy={busy_us / 1e3:.2f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; device ms by kind: " +
          ", ".join(f"{k} {v:.3f}" for k, v in _kind_ms(rows).items()) +
          f"; top: {top}")
    cfg, dev = eng.cfg, eng.device
    mixer = {k: v[0] for k, v in eng.params["groups"][0][0]["mixer"].items()}
    w = cfg.lru_width
    n_r = sum(k == "R" for g in cfg.groups for k in g.pattern * g.repeats)
    parts = []
    for shape in ((1, S, w), (8, 1, w)):
        xs = [torch.randn(shape, device=dev).to(cfg.act_dtype)
              for _ in range(3)]
        ms = _time_ms([lambda x=x: rglru._gates(mixer, x) for x in xs],
                      iters=5)
        parts.append(f"{shape}: {ms:.4f} ms a layer, {n_r * ms:.3f} ms over "
                     f"{n_r} layers")
    copy_gb = 2 * w * w * (2 + 4 + 4) / 1e9   # read bf16, write and read fp32
    print(f"[profile {label} gates] rglru._gates of one layer (two fp32 "
          f"products over fp32 copies of w_a and w_i made at every call): "
          + "; ".join(parts) + f"; the copies move {copy_gb:.3f} GB a layer "
          f"and call, {n_r * copy_gb:.2f} GB a decode step over {n_r} "
          f"layers")


def _device_time(prof, label):
    """From a profile: the device's busy time (the union of its kernels'
    intervals, us), (us, count, name) rows by kernel, written to
    ``OUT_DIR / chip_smoke_profile_<label>.txt``, and the top five."""
    from torch.autograd import DeviceType
    by_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or \
                getattr(ev, "is_user_annotation", False):
            continue
        t = ev.time_range
        spans.append((t.start, t.end))
        us, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (us + t.end - t.start, n + 1)
    busy_us, last_end = 0.0, float("-inf")
    for a, b in sorted(spans):          # union of device intervals
        if b > last_end:
            busy_us += b - max(a, last_end)
            last_end = b
    rows = sorted(((us, n, k) for k, (us, n) in by_name.items()),
                  reverse=True)
    OUT_DIR.mkdir(exist_ok=True)
    name = label.replace(" ", "_")
    (OUT_DIR / f"chip_smoke_profile_{name}.txt").write_text("\n".join(
        f"{us / 1e3:10.3f} ms {n:6d}x  {key}" for us, n, key in rows))
    top = "; ".join(f"{key[:40]} {us / 1e3:.2f}ms/{n}x"
                    for us, n, key in rows[:5])
    return busy_us, rows, top


def _profile_decode_sync(eng, tok, label):
    """One K=8 decode sync of 8 slots timed on the host clock, then the
    next one under ``torch.profiler``: device time by kernel and the
    device's idle share of that sync's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for p in [tok(300) for _ in range(8)]:
        eng.submit(p, max_new=24)
    eng.step()                          # admit + first sync
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()                          # second sync, unprofiled
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=bool(eng.cfg.kv_lora_rank)) as prof:
        t0 = time.perf_counter()
        eng.step()                      # third sync, profiled
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.run_until_drained()
    busy_us, rows, top = _device_time(prof, label)
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:8]
    print(f"[profile {label}] host self time under the profiler, top: " +
          "; ".join(f"{e.key[:36]} {e.self_cpu_time_total / 1e3:.1f}ms/"
                    f"{e.count}x" for e in host))
    print(f"[profile {label}] one decode sync (K=8, 8 slots, ~300-token "
          f"contexts): unprofiled wall={step_ms:.2f}ms; profiled "
          f"wall={wall_ms:.2f}ms"
          f" device_busy={busy_us / 1e3:.2f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; top: {top}")
    decode = [f"{key[:60]} {us / 1e3:.3f}ms/{n}x ({us / n:.2f}us a call)"
              for us, n, key in rows if "decode" in key.lower()]
    if decode:
        print(f"[profile {label}] decode attention kernels: " +
              "; ".join(decode))
    if eng.cfg.lru_width:
        print(f"[profile {label}] device ms by kind: " + ", ".join(
            f"{k} {v:.3f}" for k, v in _kind_ms(rows).items()) +
            f"; busy {busy_us / 1e3:.2f}ms")
    if eng.cfg.n_experts:
        # device time of each op's kernels: the expert products are the
        # MoE's three bmm a layer, the other GEMMs the projections and head
        by_op = {e.key: e for e in prof.key_averages()}
        parts = []
        for op, what in (("aten::bmm", "expert products"),
                         ("aten::mm", "other GEMMs"),
                         ("aten::topk", "router top-k"),
                         ("aten::sort", "dispatch sort")):
            e = by_op.get(op)
            us = getattr(e, "device_time_total", 0.0) if e else 0.0
            parts.append(f"{what} ({op}) {us / 1e3:.3f}ms/"
                         f"{e.count if e else 0}x")
        attn_us = sum(us for us, _, key in rows if "decode" in key.lower())
        print(f"[profile {label}] device time by op: " + "; ".join(parts) +
              f"; decode attention kernels {attn_us / 1e3:.3f}ms; busy "
              f"{busy_us / 1e3:.2f}ms")
    if eng.cfg.kv_lora_rank:
        # MLA's absorption products (q_nope w_uk, ctx w_uv) are batched
        # over the heads, the expert products over the experts: the bmm's
        # first operand tells them apart
        by = {"expert products": [0.0, 0], "absorption products": [0.0, 0]}
        for e in prof.key_averages(group_by_input_shape=True):
            if e.key != "aten::bmm":
                continue
            first = e.input_shapes[0] if e.input_shapes else []
            kind = "expert products" if first and \
                first[0] == eng.cfg.n_experts else "absorption products"
            by[kind][0] += getattr(e, "device_time_total", 0.0)
            by[kind][1] += e.count
        mla = [(us, n) for us, n, key in rows if "mla_decode" in key]
        check(mla, f"{label}: the profiled sync ran no mla_decode_kernel")
        print(f"[profile {label}] MLA sync by kind: " + "; ".join(
            f"{k} (aten::bmm) {us / 1e3:.3f}ms/{n}x" for k, (us, n) in
            by.items()) + f"; the MLA decode kernel "
            f"{sum(us for us, _ in mla) / 1e3:.3f}ms/"
            f"{sum(n for _, n in mla)}x "
            f"({sum(us for us, _ in mla) / sum(n for _, n in mla):.2f}us a "
            f"call); busy {busy_us / 1e3:.2f}ms")


# ----------------------------------------------------------------------
def _links(res):
    return {(c, e): s for c, e, s in res.links}


def phase_margot():
    """The paper's pipeline at d = 1024 through the port's argmining
    driver; returns the pair score's launches in the DS2 batch."""
    import statistics

    import torch
    from repro_torch import kernels
    from repro_torch.configs.margot_svm import DATASETS, PIPELINE
    from repro_torch.data.text import margot_models
    from repro_torch.kernels import ops
    from repro_torch.launch import argmining
    dev = torch.device("cuda", 0)
    others = [k for k in kernels.LAUNCHES if k != "pair_score"]

    def counts():
        return dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)

    # (a) DS1 through the kernel, then forced onto the plain version
    X, keys, _ = argmining.make_corpus(DATASETS["DS1"], PIPELINE.feat_dim)
    models = margot_models(PIPELINE, device=dev)
    runs = {}
    for label, plain in (("kernel", False), ("plain", True)):
        ops.reset_counts()
        with _forced_plain(plain):
            res = argmining.run_batch(models, X, keys, PIPELINE, 12, 2, dev)
        launches, calls = counts()
        used, unused = (calls, launches) if plain else (launches, calls)
        check(res.n_dropped == 0 and used["pair_score"] == res.launched and
              not any(unused.values()) and
              not any(launches[k] for k in others),
              f"DS1 {label} run: n_dropped {res.n_dropped}, launched "
              f"{res.launched}, launches {launches}, plain {calls}")
        runs[label] = _links(res)
    kern, plain = runs["kernel"], runs["plain"]
    limit = PAIR_REL * max(abs(x) for x in [*kern.values(), *plain.values()])
    only = {p: (kern.get(p), plain.get(p)) for p in kern.keys() ^ plain.keys()}
    check(all(abs(a if a is not None else b) <= limit
              for a, b in only.values()),
          f"DS1: links differ beyond |score| {limit:.3e}: {only}")
    diff = max(abs(kern[p] - plain[p]) for p in kern.keys() & plain.keys())
    check(diff <= limit, f"DS1: common links' scores differ by {diff:.3e}, "
          f"limit {limit:.3e}")
    print(f"[margot DS1] {len(X)} sentences, {len(kern)} links through the "
          f"kernel, {len(plain)} through the plain version on the card: "
          f"{len(only)} pairs in one set only (each |score| <= {limit:.3e}),"
          f" common scores within {diff:.3e} (limit {PAIR_REL} x max "
          f"|score|)")

    # (b) the DS2 batch through the entry point
    ops.reset_counts()
    res = argmining.main(["batch", "--device", "cuda", "--dataset", "DS2",
                          "--workers", "2"])
    launches, calls = counts()
    check(res.n_dropped == 0, f"DS2: n_dropped {res.n_dropped}")
    check(launches["pair_score"] == res.launched and
          not any(launches[k] for k in others) and not any(calls.values()),
          f"DS2: launches {launches}, plain {calls}, partition runs "
          f"{res.launched}")
    print(f"[margot DS2] pair_score launches={launches['pair_score']} "
          f"(partitions={res.partitions}, speculated={res.speculated}) "
          f"plain_calls={sum(calls.values())} links={len(res.links)} "
          f"n_dropped=0 wall={res.wall_s:.3f}s sentences/s="
          f"{DATASETS['DS2'] / res.wall_s:.1f}")
    ds2_launches = launches["pair_score"]

    # (c) Table 2's largest model, M3, on DS1
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_counts()
    res = argmining.main(["batch", "--device", "cuda", "--dataset", "DS1",
                          "--model-sv", "M3", "--workers", "2"])
    launches, calls = counts()
    check(launches["pair_score"] == res.launched and
          not any(calls.values()), f"M3: launches {launches}, plain {calls}")
    print(f"[margot M3] DS1 with 30,363 support vectors per SVM: wall="
          f"{res.wall_s:.3f}s n_dropped={res.n_dropped} links="
          f"{len(res.links)} pair_score launches={launches['pair_score']} "
          f"peak_mem={torch.cuda.max_memory_allocated(dev) / 2**30:.2f}GiB")

    # (d) the stream's rate ramp, scope-window then scope-file
    for scope in ("window", "file"):
        ops.reset_counts()
        rt, rate = argmining.main(["stream", "--device", "cuda", "--scope",
                                   scope])
        launches, calls = counts()
        check(launches["pair_score"] > 0 and
              not any(launches[k] for k in others) and
              not any(calls.values()) and rate > 0,
              f"stream {scope}: rate {rate}, launches {launches}, plain "
              f"{calls}")
        busy = statistics.median(st.busy_s for st in rt.stats)
        print(f"[margot stream {scope}] max sustainable rate {rate:.0f} "
              f"inst/s; pair_score launches={launches['pair_score']} "
              f"plain_calls=0; steady micro-batch (64 instances, one 1024-row"
              f" chunk) busy median {busy * 1e3:.2f}ms")

    _profile_partition(models, X, keys)
    return {"pair_score": ds2_launches}


def _profile_partition(models, X, keys):
    """One batch partition (12 documents of DS1) on the host clock, then
    under ``torch.profiler``: device busy time, idle share, kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.margot_svm import PIPELINE
    from repro_torch.core.pipeline import extract_links, make_batch_step
    from repro_torch.launch.argmining import partition_bounds
    dev = torch.device("cuda", 0)
    s, e = partition_bounds(keys, 12)[0]
    step = make_batch_step(PIPELINE)

    def part():
        out = step(models, torch.from_numpy(X[s:e]).to(dev),
                   torch.from_numpy(keys[s:e]).to(dev))
        return extract_links(out)

    part()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    part()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        part()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, rows, top = _device_time(prof, "margot_partition")
    print(f"[profile margot] one batch partition ({e - s} sentences, "
          f"capacities {PIPELINE.claim_capacity}/{PIPELINE.evid_capacity}): "
          f"unprofiled wall={step_ms:.2f}ms; profiled wall={wall_ms:.2f}ms "
          f"device_busy={busy_us / 1e3:.3f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; top: {top}")


# ----------------------------------------------------------------------
# internlm2-1.8b at full width, as phase 4 serves it; 16 prompts of 16-512
# tokens and 32 new tokens each (the first from the prefill)
CLUSTER_LM = dict(arch="internlm2-1.8b", reduce=False, max_len=2048,
                  slots=8, sync_every=8, seed=0)
CLUSTER_PROMPTS = (16, 512, 100, 300, 64, 200, 33, 450, 128, 256, 40, 380,
                   90, 500, 20, 160)
CLUSTER_NEW = 32


def phase_cluster():
    """The paper's service architecture on the card: ``MLaaSService`` in
    front of a ``Router`` over thread and process replicas of the port's
    engines and of the MARGOT stream, a replica SIGKILLed mid-run, and
    the partition autotuner fitted on the card.  The worker processes only
    load the libraries phase 1 built: the build directory is unchanged."""
    from repro_torch.kernels import build
    before = {p.name: p.stat().st_mtime_ns
              for p in build.BUILD_DIR.iterdir()}
    _cluster_parity()
    _cluster_threads()
    _cluster_processes()
    _cluster_stream()
    _cluster_autotuner()
    after = {p.name: p.stat().st_mtime_ns for p in build.BUILD_DIR.iterdir()}
    check(after == before, f"the workers rebuilt kernels: build directory "
          f"{sorted(before)} became {sorted(after)}")
    print(f"[cluster] every worker loaded the {len(build.SOURCES)} "
          f"libraries phase 1 built; no nvcc ran after phase 1")


def _spawn(router, spec, n, cfg):
    """Add ``n`` process replicas of ``spec`` to ``router``, spawned
    together; returns them and each one's seconds to ready (the worker's
    torch import, CUDA context and backend build)."""
    from concurrent.futures import ThreadPoolExecutor

    def add(_):
        t0 = time.perf_counter()
        w = router.add_replica(spec=spec, cfg=cfg, transport="process")
        return w, time.perf_counter() - t0

    with ThreadPoolExecutor(n) as pool:
        done = list(pool.map(add, range(n)))
    return [w for w, _ in done], [s for _, s in done]


def _worker_launches(router, keys):
    """Kernel launches the process replicas counted and shipped over
    their heartbeats (``kernels.launches.<name>``); after ``stop()``
    the departed replicas' last snapshots hold them."""
    from repro_torch import kernels
    snap = router.cluster_snapshot()
    got = {k: int(snap.get(f"kernels.launches.{k}", 0))
           for k in kernels.LAUNCHES}
    check(all(got[k] > 0 for k in keys) and
          sum(got.values()) == sum(got[k] for k in keys),
          f"worker kernel launches {got}, expected only {keys}")
    return {k: got[k] for k in keys}, snap


def _cluster_parity():
    """fp32 reduced internlm2-1.8b, dense then paged: the service over a
    Router of 2 process replicas gives an in-process engine's greedy
    tokens on the same seeded weights, token for token."""
    import numpy as np
    import torch
    from repro_torch.cluster import ReplicaConfig, Router, engine_spec
    from repro_torch.cluster.backends import make_engine
    from repro_torch.core.service import MLaaSService
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(4)
    for paged in (False, True):
        kw = dict(arch="internlm2-1.8b", reduce=True, max_len=64, slots=2,
                  sync_every=4, paged=paged, block_size=8, seed=0)
        eng = make_engine(device=dev, **kw)
        prompts = [rng.randint(0, eng.cfg.vocab, n).astype(np.int32)
                   for n in (5, 9, 7, 12, 6, 3, 17, 30)]
        want = [r.out_tokens for r in _drain(eng, prompts, 6)]
        del eng
        router = Router(policy="round_robin")
        workers, spawn_s = _spawn(router, engine_spec(device="cuda", **kw),
                                  2, ReplicaConfig(max_batch=8))
        svc = MLaaSService(router=router, capacity=len(prompts)).start()
        reqs = [svc.submit((p, 6), timeout_s=120.0) for p in prompts]
        check(all(q.done.wait(180.0) for q in reqs), "parity: a request "
              "never finished")
        svc.stop()
        router.stop()
        label = "paged" if paged else "dense"
        check([q.result for q in reqs] == want,
              f"parity {label}: process replicas gave "
              f"{[q.result for q in reqs]}, the in-process engine {want}")
        check(all(w.processed > 0 for w in workers),
              f"parity {label}: a replica served nothing")
        used, _ = _worker_launches(
            router, PAGED_KERNELS if paged else DENSE_KERNELS)
        print(f"[cluster parity {label}] fp32 reduced internlm2-1.8b: "
              f"{len(prompts)} requests through MLaaSService -> Router -> 2 "
              f"process replicas ({[w.processed for w in workers]} each, "
              f"spawned in {', '.join(f'{s:.1f}' for s in spawn_s)}s) give "
              f"the in-process engine's {sum(map(len, want))} tokens "
              f"exactly; worker launches {used}")


def _service_run(router, prompts, label):
    """The 16 requests through ``MLaaSService(router=...)``: every one
    completes with its 32 tokens; returns the wall seconds."""
    from repro_torch.core.service import MLaaSService
    svc = MLaaSService(router=router, capacity=len(prompts)).start()
    t0 = time.perf_counter()
    reqs = [svc.submit((p, CLUSTER_NEW - 1), timeout_s=120.0)
            for p in prompts]
    check(all(q.done.wait(300.0) for q in reqs),
          f"{label}: a request never finished")
    wall = time.perf_counter() - t0
    svc.stop()
    for i, q in enumerate(reqs):
        check(isinstance(q.result, list) and len(q.result) == CLUSTER_NEW
              and not q.missed_deadline,
              f"{label}: request {i} gave {q.result!r}")
    return wall


def _lm_prompts(vocab):
    import numpy as np
    rng = np.random.RandomState(5)
    return [rng.randint(0, vocab, n).astype(np.int32)
            for n in CLUSTER_PROMPTS]


def _cluster_threads():
    """Full width, paged, 2 thread replicas sharing one copy of the
    weights behind the service; the parent counts the kernel launches."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.cluster import (EngineBackend, ReplicaConfig, Router,
                                     Status)
    from repro_torch.cluster.backends import make_engine
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine
    dev = torch.device("cuda", 0)
    first = make_engine(device=dev, paged=True, block_size=16, **CLUSTER_LM)
    check(first.cfg.n_layers == 24 and first.cfg.d_model == 2048 and
          first.params["lm_head"].dtype == torch.bfloat16 and first.paged,
          "not the full-width bf16 config")
    engines = [first, Engine(first.params, first.cfg, first.scfg,
                             device=dev)]
    router = Router(policy="round_robin")
    workers = [router.add_replica(EngineBackend(e), ReplicaConfig(max_batch=8))
               for e in engines]
    prompts = _lm_prompts(first.cfg.vocab)
    warm = [router.submit((p[:40], 8), timeout_s=120.0) for p in prompts[:2]]
    check(all(router.wait(q, 180.0) is not None and q.status is Status.OK
              for q in warm), "threads: warm-up failed")
    served = [w.processed for w in workers]
    ops.reset_counts()
    torch.cuda.synchronize()
    wall = _service_run(router, prompts, "threads")
    torch.cuda.synchronize()
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    served = [w.processed - s for w, s in zip(workers, served)]
    router.stop()
    check(all(n >= 1 for n in served), f"threads: served {served}")
    check(all(launches[k] > 0 for k in PAGED_KERNELS) and
          sum(launches.values()) == sum(launches[k] for k in PAGED_KERNELS)
          and not any(plain.values()),
          f"threads: launches {launches}, plain {plain}")
    n_tok = len(prompts) * CLUSTER_NEW
    print(f"[cluster threads] internlm2-1.8b full width, paged, "
          f"MLaaSService -> Router -> 2 thread replicas (one copy of the "
          f"weights): {len(prompts)} requests of {min(CLUSTER_PROMPTS)}-"
          f"{max(CLUSTER_PROMPTS)} prompt tokens, {CLUSTER_NEW} new tokens "
          f"each, all OK; served {served}; wall={wall:.3f}s "
          f"tok/s={n_tok / wall:.1f}; launches "
          f"{ {k: launches[k] for k in PAGED_KERNELS} } plain_calls=0")
    del engines, first, workers, router
    gc.collect()
    torch.cuda.empty_cache()


def _timed_run(router, prompts, label):
    """The 16 requests straight into the Router, each with a partial-
    result callback: (tok/s, TTFT p50, TTFT p99) on the host clock, TTFT
    from submission to the first token's frame.  With one replica of 8
    slots the second 8 requests wait for the first 8 to finish."""
    import numpy as np
    from repro_torch.cluster import Status
    first = {}
    reqs = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        reqs.append(router.submit(
            (p, CLUSTER_NEW - 1), cost=CLUSTER_NEW, timeout_s=300.0,
            on_partial=lambda f, i=i: first.setdefault(i, time.monotonic())))
    outs = [router.wait(q, 400.0) for q in reqs]
    wall = time.perf_counter() - t0
    check(all(q.status is Status.OK and len(o) == CLUSTER_NEW
              for q, o in zip(reqs, outs)) and len(first) == len(reqs),
          f"{label}: statuses {[q.status for q in reqs]}")
    ttft = [first[i] - q.submitted_s for i, q in enumerate(reqs)]
    return (len(reqs) * CLUSTER_NEW / wall, float(np.percentile(ttft, 50)),
            float(np.percentile(ttft, 99)))


def _cluster_processes():
    """Full width, dense, 2 process replicas (each its own CUDA context,
    weights and KV): the service run, the same requests timed on 2
    replicas, a SIGKILL of one replica mid-run (every request completes
    exactly once, on the survivor), then the same requests on the
    survivor alone.  The engines' counters arrive over the heartbeats."""
    import threading

    from repro_torch.cluster import (MetricsRegistry, ReplicaConfig, Router,
                                     Status, engine_spec)
    from repro_torch.cluster.replica import ClusterRequest
    from repro_torch.configs import get_config
    m = MetricsRegistry()
    router = Router(policy="round_robin", metrics=m, max_retries=3)
    cfg = ReplicaConfig(max_batch=8)
    workers, spawn_s = _spawn(
        router, engine_spec(device="cuda", paged=False, **CLUSTER_LM), 2,
        cfg)
    check(max(spawn_s) < cfg.spawn_timeout_s, f"spawn took {spawn_s}s")
    print(f"[cluster processes] 2 process replicas of internlm2-1.8b (full "
          f"width, bf16, dense) spawned together, ready in "
          f"{', '.join(f'{s:.1f}' for s in spawn_s)}s (torch import, CUDA "
          f"context, seeded weights on the card; limit "
          f"{cfg.spawn_timeout_s:.0f}s)")
    prompts = _lm_prompts(get_config("internlm2-1.8b").vocab)
    warm = [router.submit((p[:40], 8), timeout_s=120.0) for p in prompts[:2]]
    check(all(router.wait(q, 180.0) is not None and q.status is Status.OK
              for q in warm), "processes: warm-up failed")
    served = [w.processed for w in workers]
    wall = _service_run(router, prompts, "processes")
    served = [w.processed - s for w, s in zip(workers, served)]
    check(all(n >= 1 for n in served), f"processes: served {served}")
    print(f"[cluster processes] MLaaSService -> Router -> 2 process "
          f"replicas: {len(prompts)} requests, {CLUSTER_NEW} new tokens "
          f"each, all OK; served {served}; wall={wall:.3f}s "
          f"tok/s={len(prompts) * CLUSTER_NEW / wall:.1f}")
    two = [_timed_run(router, prompts, "2 replicas") for _ in range(2)]

    # a replica SIGKILLed as the first token arrives: no replica can have
    # acked yet (a batch acks when its last request ends), so every
    # request must complete exactly once, on the survivor
    victim, survivor = workers
    counts, lock, orig = {}, threading.Lock(), ClusterRequest.complete

    def counting(req, result, replica_rid):
        with lock:
            counts[id(req)] = counts.get(id(req), 0) + 1
        return orig(req, result, replica_rid)

    started = threading.Event()
    with mock.patch.object(ClusterRequest, "complete", counting):
        reqs = [router.submit((p, CLUSTER_NEW - 1), cost=CLUSTER_NEW,
                              timeout_s=300.0,
                              on_partial=lambda f: started.set())
                for p in prompts]
        check(started.wait(120.0), "kill: no first token")
        victim.inject_crash()               # SIGKILL
        outs = [router.wait(q, 400.0) for q in reqs]
    check(all(q.status is Status.OK and len(o) == CLUSTER_NEW and
              counts.get(id(q)) == 1 and q.replica_rid == survivor.rid
              for q, o in zip(reqs, outs)),
          f"kill: statuses {[q.status for q in reqs]}, completions "
          f"{[counts.get(id(q)) for q in reqs]}, replicas "
          f"{[q.replica_rid for q in reqs]}")
    check(not victim.alive and router.n_alive() == 1, "kill: victim alive")
    snap = m.snapshot()
    print(f"[cluster kill] SIGKILL of replica {victim.rid} at the first "
          f"token: {len(reqs)} requests each completed exactly once, all "
          f"on replica {survivor.rid}; replica.crashes="
          f"{snap.get('replica.crashes', 0):.0f} router.requeued="
          f"{snap.get('router.requeued', 0):.0f} router.failed="
          f"{snap.get('router.failed', 0):.0f}")
    one = [_timed_run(router, prompts, "1 replica") for _ in range(2)]
    router.stop()
    used, snap = _worker_launches(router, DENSE_KERNELS)
    check(snap.get("engine.requests", 0) >= 2 * len(prompts) and
          snap.get("engine.tokens", 0) > 0,
          f"engine counters over the heartbeats: requests "
          f"{snap.get('engine.requests')}, tokens {snap.get('engine.tokens')}")
    runs = lambda rs: "; ".join(  # noqa: E731
        f"tok/s={r[0]:.1f} TTFT p50={r[1]:.3f}s p99={r[2]:.3f}s" for r in rs)
    print(f"[cluster processes] same {len(prompts)} requests straight into "
          f"the Router, twice each: 1 process replica {runs(one)}; 2 process "
          f"replicas {runs(two)}; over the "
          f"heartbeats: engine.requests={snap['engine.requests']:.0f} "
          f"engine.tokens={snap['engine.tokens']:.0f} "
          f"engine.prefill_batches="
          f"{snap.get('engine.prefill_batches', 0):.0f}, worker launches "
          f"{used}")


def _cluster_stream():
    """The MARGOT stream at phase 5's settings behind the Router: one
    process replica gives an in-process runtime's links on the same
    micro-batches; then 2 replicas, where every micro-batch acks."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.cluster import ReplicaConfig, Router, Status, stream_spec
    from repro_torch.configs.margot_svm import PIPELINE, STREAM
    from repro_torch.core.stream import StreamRuntime
    from repro_torch.data.text import (corpus_arrays, margot_models,
                                       synthetic_corpus)
    dev = torch.device("cuda", 0)
    kw = dict(feat_dim=PIPELINE.feat_dim,
              claim_capacity=PIPELINE.claim_capacity,
              evid_capacity=PIPELINE.evid_capacity,
              **{f.name: getattr(STREAM, f.name)
                 for f in dataclasses.fields(STREAM)})
    X, keys, _ = corpus_arrays(synthetic_corpus(8, 64, seed=1),
                               dim=PIPELINE.feat_dim)
    rng = np.random.RandomState(0)
    n = STREAM.capacity

    def mb(i):
        idx = rng.randint(0, len(keys), n)
        ts = i * STREAM.period + np.linspace(
            0, STREAM.period, n, endpoint=False).astype(np.float32)
        return X[idx], keys[idx], ts

    mbs = [mb(i) for i in range(6)]
    rt = StreamRuntime(margot_models(PIPELINE, device=dev), PIPELINE, STREAM)
    want = [rt.process_microbatch(*b) for b in mbs]
    router = Router(policy="round_robin")
    cfg = ReplicaConfig(max_batch=8)
    _, spawn_s = _spawn(router, stream_spec(device="cuda", **kw), 1, cfg)
    reqs = [router.submit(b, cost=n, timeout_s=120.0) for b in mbs]
    outs = [router.wait(q, 180.0) for q in reqs]
    check(all(q.status is Status.OK for q in reqs),
          f"stream: statuses {[q.status for q in reqs]}")
    links = 0
    for i, ((sc, ok), (wsc, wok)) in enumerate(zip(outs, want)):
        check(isinstance(sc, np.ndarray) and np.array_equal(ok, wok) and
              np.array_equal(sc, wsc),
              f"stream micro-batch {i}: the replica's links differ from "
              f"the in-process runtime's")
        links += int(ok.sum())
    more, more_s = _spawn(router, stream_spec(device="cuda", **kw), 1, cfg)
    reqs = [router.submit(mb(6 + i), cost=n, timeout_s=120.0)
            for i in range(8)]
    outs = [router.wait(q, 180.0) for q in reqs]
    check(all(q.status is Status.OK and o[0].shape == want[0][0].shape
              for q, o in zip(reqs, outs)),
          f"stream, 2 replicas: statuses {[q.status for q in reqs]}")
    router.stop()
    used, _ = _worker_launches(router, ("pair_score",))
    print(f"[cluster stream] MARGOT stream (d={PIPELINE.feat_dim}, "
          f"{n}-row chunks, period {STREAM.period}s, window "
          f"{STREAM.window}s) on 1 process replica (ready in "
          f"{spawn_s[0]:.1f}s): {len(mbs)} micro-batches, scores and "
          f"{links} links bit-identical to the in-process runtime's; then "
          f"2 replicas (the second ready in {more_s[0]:.1f}s): 8 "
          f"micro-batches, all acked; worker launches {used}")


def _cluster_autotuner():
    """``measure_step`` over the port's MARGOT batch step at 3-48
    documents a partition, the fitted cost model and the size it picks
    for a 0.25 s budget, beside ``launch/argmining.py``'s fixed 12.  A
    finding, not a check; the claim capacity caps a partition."""
    import torch
    from repro_torch.configs.margot_svm import PIPELINE
    from repro_torch.core.partitioner import (choose_partition_size,
                                              measure_step)
    from repro_torch.core.pipeline import extract_links, make_batch_step
    from repro_torch.data.text import margot_models
    from repro_torch.launch import argmining
    dev = torch.device("cuda", 0)
    sizes = (3, 6, 12, 24, 48)
    spd = argmining.SENTENCES_PER_DOC
    X, keys, _ = argmining.make_corpus(max(sizes) * spd, PIPELINE.feat_dim)
    models = margot_models(PIPELINE, device=dev)
    step = make_batch_step(PIPELINE)
    dropped = {}

    def step_fn(m):
        n = m * spd
        out = step(models, torch.from_numpy(X[:n]).to(dev),
                   torch.from_numpy(keys[:n]).to(dev))
        extract_links(out)              # reads the result: synchronizes
        dropped[m] = int(out.n_dropped)

    model = measure_step(step_fn, sizes, warmup=1, repeats=5)
    chosen = choose_partition_size(model, latency_budget_s=STREAM_BUDGET_S)
    fits = max(m for m in sizes if dropped[m] == 0)
    print(f"[cluster autotuner] MARGOT batch step at {list(sizes)} documents "
          f"a partition ({spd} sentences each, capacities "
          f"{PIPELINE.claim_capacity}/{PIPELINE.evid_capacity}): fitted "
          f"overhead={model.overhead_s * 1e3:.4f}ms per_doc="
          f"{model.per_item_s * 1e3:.4f}ms r2={model.r2:.4f}; "
          f"choose_partition_size(budget {STREAM_BUDGET_S}s, efficiency "
          f"0.8) = {chosen} documents; dropped rows by size "
          f"{dropped}, so the capacities cap a partition at {fits} of "
          f"these sizes; launch/argmining.py runs "
          f"{argmining.DOCS_PER_PARTITION}")


# ----------------------------------------------------------------------
# internlm2-1.8b at phase 4's full width on the paged engine: bs 16, 8
# slots, max_len 2048, K=8, phase 4's 8 requests, max_new 32
LIFECYCLE = dict(max_len=2048, slots=8, sync_every=8, paged=True,
                 block_size=16, seed=0)
#: phase 7's swap pool: the 8 prompts take 87 blocks of 16 rows once the
#: shared prefix is cached, and 103 with their 32 new tokens; in 80
#: blocks admits wait for room and two sessions swap out as the others
#: grow (the host's decisions depend on lengths alone: a CPU run of the
#: reduced config at these lengths swaps the same two)
SWAP_BLOCKS = 80


def phase_lifecycle(paged_tokens):
    """The paged engine's KV lifecycle at full width: speculative decode
    through the paged extend kernel, a greedy fork, KV swap on both
    tiers, export/import between two engines, and 2 thread replicas
    behind the Router through brownout L1 and a migrating drain."""
    import gc

    import torch
    from repro_torch.launch.serve import build_engine
    base = build_engine("internlm2-1.8b", device=torch.device("cuda", 0),
                        **LIFECYCLE)
    check(base.cfg.n_layers == 24 and base.cfg.d_model == 2048 and
          base.params["lm_head"].dtype == torch.bfloat16 and base.paged,
          "not the full-width bf16 config")
    tok, warm, prompts = _serve_prompts(base.cfg.vocab)
    _lifecycle_spec(base, warm, prompts, paged_tokens)
    _lifecycle_fork(base, prompts)
    for tier in ("host", "artifact"):
        _lifecycle_swap(base, prompts, paged_tokens, tier)
    _lifecycle_export(base, prompts, tok)
    _lifecycle_cluster(base, prompts)
    del base
    gc.collect()
    torch.cuda.empty_cache()


def _variant(base, **changes):
    """An engine on ``base``'s weights with its ServeConfig changed."""
    import dataclasses

    from repro_torch.serving import Engine
    return Engine(base.params, base.cfg,
                  dataclasses.replace(base.scfg, **changes),
                  device=base.device)


def _agreement(got, want):
    """Share of equal tokens, and each request's first differing index
    (None where equal)."""
    same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
    first = [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b),
                  None if len(g) == len(w) else min(len(g), len(w)))
             for g, w in zip(got, want)]
    return same / sum(len(w) for w in want), first


def _check_served(reqs, vocab, label):
    for r in reqs:
        check(r.finish_reason == "max_new" and len(r.out_tokens) == 33 and
              all(0 <= t < vocab for t in r.out_tokens),
              f"{label}: request {r.rid} {r.finish_reason}, {r.out_tokens}")


def _lifecycle_spec(base, warm, prompts, paged_tokens):
    """(a) Speculative decode, d=3: every verify window and admit runs the
    paged extend (24 launches a pass), no paged decode and no plain
    version; tokens against phase 4's paged run (bf16: not a gate)."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    eng = _variant(base, speculative=True, spec_draft=3)
    check(eng.speculative, "speculation fell back")
    _drain(eng, [warm], 8)
    keys = ("engine.prefill_batches", "engine.steps", "engine.spec_proposed",
            "engine.spec_accepted")
    before = {k: eng.metrics.counter(k).value for k in keys}
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS)
    n = {k: eng.metrics.counter(k).value - v for k, v in before.items()}
    _check_served(reqs, eng.cfg.vocab, "spec")
    want = eng.cfg.n_layers * (n["engine.prefill_batches"] +
                               eng.scfg.sync_every * n["engine.steps"])
    check(launches["paged_extend_attention"] == want and
          sum(launches.values()) == want and not any(plain.values()),
          f"spec: launches {launches} (expected {want} paged extends "
          f"alone), plain {plain}")
    share, first = _agreement([r.out_tokens for r in reqs], paged_tokens)
    gen = sum(r.decoded for r in reqs)
    ttft = sorted(r.first_token_t - r.submit_t for r in reqs)
    print(f"[lifecycle spec] d=3: {len(reqs)} requests, {gen} decoded in "
          f"{n['engine.steps']} syncs and {n['engine.prefill_batches']} "
          f"admit batches, wall={wall:.3f}s tok/s={gen / wall:.1f} "
          f"ttft_p50={ttft[len(ttft) // 2]:.3f}s ttft_max={ttft[-1]:.3f}s; "
          f"accepted {n['engine.spec_accepted']} of "
          f"{n['engine.spec_proposed']} drafts "
          f"({n['engine.spec_accepted'] / n['engine.spec_proposed']:.4f}); "
          f"paged extend launches {launches['paged_extend_attention']} = "
          f"24 x ({n['engine.prefill_batches']} + 8 x {n['engine.steps']}), "
          f"paged decode 0, plain 0; tokens equal to phase 4's paged run: "
          f"{share:.4f} (bf16; first differing index per request {first})")
    del eng


def _lifecycle_fork(base, prompts):
    """(b) A greedy fork 3 ways at the first token: parent and children
    decode one context in one batch, so every child's tokens are the
    parent's, in bf16 too."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    eng = _variant(base)
    children = []

    def fork_at_first(req, toks, done):
        if len(req.out_tokens) == 1 and not children:
            children.extend(eng.fork(req, max_new=req.max_new)
                            for _ in range(3))

    ops.reset_counts()
    parent = eng.submit(prompts[0], max_new=32, on_tokens=fork_at_first)
    eng.run_until_drained()
    launches = dict(kernels.LAUNCHES)
    check(len(children) == 3, f"fork: {len(children)} children, stream "
          f"errors {eng.metrics.counter('engine.stream_errors').value}")
    _check_served([parent] + children, eng.cfg.vocab, "fork")
    for i, c in enumerate(children):
        diff = _agreement([c.out_tokens], [parent.out_tokens])[1][0]
        check(diff is None, f"fork: child {i} differs from the parent at "
              f"token {diff}: a row-dependent result")
    cow = eng.metrics.counter("engine.kv_cow_copies").value
    check(cow > 0 and eng.alloc.free_blocks + eng.alloc.cached_blocks ==
          eng.alloc.num_blocks, f"fork: {cow} COW copies, or blocks leaked")
    check(launches["paged_decode_attention"] > 0 and
          launches["paged_extend_attention"] > 0, f"fork: {launches}")
    print(f"[lifecycle fork] {len(prompts[0])}-token prompt forked 3 ways "
          f"at its first token: parent and children decode 32 tokens each, "
          f"all 3 children equal to the parent; {cow} COW copies; launches "
          f"{ {k: launches[k] for k in PAGED_KERNELS} }")
    del eng


def _lifecycle_swap(base, prompts, paged_tokens, tier):
    """(c) KV swap on a pool that holds the prompts but not their decode
    growth: every request completes once, swaps out and in as often, no
    pool exhaustion, and each restore writes back exactly the bytes the
    swap-out read."""
    eng = _variant(base, kv_blocks=SWAP_BLOCKS, kv_swap=True,
                   swap_tier=tier)
    trips = []                          # (bytes equal, frame bytes, tokens)
    restore = eng._try_restore

    def checked_restore(free):
        req = eng.queue[0]
        snap = req.kv_snapshot
        done = restore(free)
        slot = next((s for s, r in enumerate(eng.active) if r is req), None)
        if slot is not None and snap.n_blocks:
            data = snap.data if snap.data is not None else \
                eng._swap_payload_store().read_bytes(snap.digest)
            table = eng.alloc.table(eng._seq_of_slot[slot])
            trips.append((eng._gather_block_rows(
                table[:snap.n_blocks]) == data, len(data), snap.pos))
        return done

    eng._try_restore = checked_restore
    t0 = time.perf_counter()
    reqs = _drain(eng, prompts, 32)
    wall = time.perf_counter() - t0
    snap = eng.metrics.snapshot()
    _check_served(reqs, eng.cfg.vocab, f"swap {tier}")
    out, back = snap.get("engine.kv_swap_out", 0), \
        snap.get("engine.kv_swap_in", 0)
    check(sorted(r.rid for r in eng.finished) == sorted(r.rid for r in reqs),
          f"swap {tier}: finished {[r.rid for r in eng.finished]}")
    check(out == back > 0 and not snap.get("engine.kv_pool_exhausted", 0),
          f"swap {tier}: out {out}, in {back}, exhausted "
          f"{snap.get('engine.kv_pool_exhausted', 0)}")
    check(trips and all(t[0] for t in trips),
          f"swap {tier}: {sum(not t[0] for t in trips)} of {len(trips)} "
          f"restores wrote other bytes than the swap-out read")
    check(eng.alloc.free_blocks + eng.alloc.cached_blocks ==
          eng.alloc.num_blocks, f"swap {tier}: blocks leaked")
    share, _ = _agreement([r.out_tokens for r in reqs], paged_tokens)
    nbytes, ntok = sum(t[1] for t in trips), sum(t[2] for t in trips)
    print(f"[lifecycle swap {tier}] pool {SWAP_BLOCKS} blocks x 16: "
          f"{len(reqs)} requests all complete once, wall={wall:.3f}s; "
          f"kv_swap_out = kv_swap_in = {out}, "
          f"{snap.get('engine.kv_swapped_blocks', 0)} blocks swapped, "
          f"kv_pool_exhausted 0; {len(trips)} restores re-read bit for "
          f"bit; {nbytes} frame bytes for {ntok} tokens "
          f"({nbytes / max(ntok, 1) / 1024:.2f} KiB a token); tokens equal "
          f"to phase 4's paged run: {share:.4f} (bf16, other batches)")
    del eng


def _lifecycle_export(base, prompts, tok):
    """(d) Engine A serves the two requests sharing the 256-token prefix
    and exports its prefix cache; engine B imports the frame, holds A's
    rows bit for bit, and serves a new prompt on that prefix from 16
    cached blocks."""
    import numpy as np
    a = _variant(base)
    _drain(a, [prompts[0], prompts[2]], 32)
    state = a.export_kv_state()
    check(state is not None and len(state["hashes"]) == 24,
          f"export: {None if state is None else len(state['hashes'])} "
          f"blocks, expected 18 + 6 full prompt blocks")
    b = _variant(base)
    n = b.import_kv_state(state)
    again = b.export_kv_state()
    check(n == 24 and again["hashes"] == state["hashes"] and
          again["data"] == state["data"],
          f"import: adopted {n}; the re-export differs from A's frame")
    prompt = np.concatenate([prompts[0][:256], tok(60)])
    (rb,) = _drain(b, [prompt], 32)
    (ra,) = _drain(a, [prompt], 32)
    hits = b.metrics.counter("engine.prefix_hit_blocks").value
    check(hits == 16, f"import: B hit {hits} blocks, expected 16")
    _check_served([ra, rb], b.cfg.vocab, "export")
    print(f"[lifecycle export] A exported {len(state['hashes'])} blocks "
          f"({len(state['data'])} bytes); B adopted {n}, its re-export "
          f"equal to A's frame byte for byte; a new prompt on the 256-token "
          f"prefix hit 16 blocks on B; B's tokens equal A's for it: "
          f"{rb.out_tokens == ra.out_tokens}")
    del a, b


def _lifecycle_cluster(base, prompts):
    """(e) 2 thread replicas (paged, speculative) behind the Router with
    session affinity: brownout L1 turns speculation off on both (the spec
    counters stop) with every request completing, then a drain with
    ``migrate=True`` ships the drained replica's KV to the survivor."""
    import numpy as np
    from repro_torch.cluster import (EngineBackend, MetricsRegistry,
                                     ReplicaConfig, Router, Status)
    engines = [_variant(base, speculative=True) for _ in range(2)]
    router = Router(policy="session_affinity", metrics=MetricsRegistry())
    workers = [router.add_replica(EngineBackend(e), ReplicaConfig(max_batch=8),
                                  kind="lm") for e in engines]

    def run(items, label):
        qs = [router.submit((p, n), session_key=key, kind="lm",
                            timeout_s=300.0) for key, p, n in items]
        outs = [router.wait(q, 400.0) for q in qs]
        check(all(q.status is Status.OK and isinstance(o, list) and
                  len(o) == n + 1 for q, o, (_, _, n) in
                  zip(qs, outs, items)),
              f"cluster {label}: {[q.status for q in qs]}")
        return qs, outs

    def proposed():
        return [e.metrics.counter("engine.spec_proposed").value
                for e in engines]

    items = [(f"s{i}", p, 31) for i, p in enumerate(prompts)]
    qs, outs = run(items, "L0")
    spec0 = proposed()
    check(sum(spec0) > 0, "cluster: no verify window ran")
    for w in router.alive_replicas():
        w.set_brownout(1)
    run(items, "L1")
    check(not any(e.speculative for e in engines) and proposed() == spec0,
          f"cluster L1: speculative {[e.speculative for e in engines]}, "
          f"proposed {spec0} -> {proposed()}")
    home = qs[0].replica_rid
    router.remove_replica(home, drain=True, migrate=True)
    moved = [i for i, q in enumerate(qs) if q.replica_rid == home]
    run([(f"s{i}", np.concatenate([prompts[i], np.asarray(outs[i],
                                                          np.int32)]), 8)
         for i in moved], "after the drain")
    survivor = next(w for w in workers if w.rid != home)
    imported = survivor.backend.engine.metrics.counter(
        "engine.kv_import_blocks").value
    migrated = router.metrics.snapshot().get("router.sessions_migrated", 0)
    router.stop()
    check(migrated > 0 and imported > 0,
          f"cluster drain: sessions_migrated {migrated}, survivor imported "
          f"{imported} blocks")
    print(f"[lifecycle cluster] 2 thread replicas (paged, speculative) "
          f"behind the Router: {len(items)} requests OK with {sum(spec0)} "
          f"drafts proposed; brownout L1: speculative off on both, the "
          f"same requests OK with no draft proposed; drain with migrate: "
          f"{migrated:.0f} sessions migrated, the survivor adopted "
          f"{imported} blocks and served the {len(moved)} continuations")
    del engines, workers, router


# ----------------------------------------------------------------------
#: phase 8's burst: phase 6's prompts (16-512 tokens) cycled into 96
#: requests of 32 new tokens, one every 0.125 s (8 a second for 12 s).
#: One process replica of internlm2-1.8b serves 160-194 tok/s, ~6 such
#: requests a second (PERF.md, section 5), and a new replica is ready in
#: ~6.3 s, so the burst outlasts a spawn and the scaled-up pool serves
#: its second half.
BURST_REQUESTS = 96
BURST_GAP_S = 0.125
#: the scaler: up when a replica's outstanding cost passes its 8 slots x
#: 32 tokens (requests queue behind full slots), down after 4 idle ticks
#: (1 s), at most one action every 2 s, 1-3 replicas
SCALER = dict(min_replicas=1, max_replicas=3, scale_up_depth=256.0,
              scale_down_depth=1.0, cooldown_s=2.0, idle_ticks_to_drain=4)
SCALER_TICK_S = 0.25
#: the sampler's period in the serve driver's default (--stats-period)
STATS_PERIOD_S = 0.25


def phase_telemetry():
    """The port's telemetry over full-width internlm2-1.8b behind the
    Router: an autoscaled burst on process replicas with the sampler, the
    SLO engine and the stats server on; the sampler's overhead on one
    engine; the serve driver's ``--stats-dump`` in a process of its own."""
    _telemetry_burst()
    _telemetry_overhead()
    _telemetry_driver()


def _fetch_routes(server):
    """The four stats routes over HTTP, each parsed (Prometheus text into
    name -> value); the bodies go to ``OUT_DIR``."""
    import urllib.request
    got = {}
    for route, ext in (("/metrics", "txt"), ("/timeseries.json", "json"),
                       ("/slo.json", "json"), ("/dash", "html")):
        with urllib.request.urlopen(server.url + route, timeout=30) as resp:
            check(resp.status == 200, f"{route}: HTTP {resp.status}")
            body = resp.read().decode()
        (OUT_DIR / f"chip_smoke_stats{route.split('.')[0].replace('/', '_')}"
                   f".{ext}").write_text(body)
        got[route] = body
    prom = {}
    for ln in got["/metrics"].splitlines():
        if ln and not ln.startswith("#"):
            name, value = ln.split()
            prom[name] = float(value)
    check(got["/dash"].startswith("<!DOCTYPE html>"), "/dash: not a page")
    return (prom, json.loads(got["/timeseries.json"]),
            json.loads(got["/slo.json"]))


def _telemetry_burst():
    """One process replica of full-width internlm2-1.8b (dense, the serve
    driver's default) behind a least-loaded Router, the serve driver's
    stats stack on its cluster snapshot (sampler, SLO engine wired into
    ``router.slo``, stats server on port 0) and an ``Autoscaler`` (1-3
    replicas, its factory an ``engine_spec``) ticked every 0.25 s, each
    tick timed (a scale-up's tick spans the spawn).  The burst: every
    request completes exactly once with its tokens; at least one scale-up
    while it lasts, then a scale-down once the pool is idle; tok/s before
    and after the first new replica is ready; all four routes parse, and
    ``/metrics`` carries the kernel launches the workers shipped."""
    import threading

    from repro_torch.cluster import (Autoscaler, AutoscalerConfig,
                                     MetricsRegistry, ReplicaConfig, Router,
                                     SLOEngine, SLOObjective, StatsServer,
                                     Status, TelemetrySampler,
                                     TimeSeriesStore, engine_spec)
    from repro_torch.cluster.replica import ClusterRequest
    from repro_torch.configs import get_config
    m = MetricsRegistry()
    router = Router(policy="least_loaded", metrics=m)
    # an inbox that holds the whole burst: a slow spawn makes requests
    # wait, never sheds them
    rcfg = ReplicaConfig(max_batch=8, inbox_capacity=BURST_REQUESTS)
    spec = engine_spec(device="cuda", paged=False, **CLUSTER_LM)
    store = TimeSeriesStore()
    slo = SLOEngine([SLOObjective(kind="any")], m)
    router.slo = slo
    sampler = TelemetrySampler(router.cluster_snapshot, store, registry=m,
                               slo=slo, period_s=STATS_PERIOD_S)
    scaler = Autoscaler(router, lambda: spec, AutoscalerConfig(
        replica_cfg=rcfg, **SCALER), metrics=m, transport="process")
    server = None
    stop = threading.Event()
    ticks = []                          # (event, seconds the tick took)

    def scale_loop():
        while not stop.wait(SCALER_TICK_S):
            t = time.perf_counter()
            ev = scaler.tick()
            if ev is not None:
                ticks.append((ev, time.perf_counter() - t, time.monotonic()))

    loop = threading.Thread(target=scale_loop, name="smoke-scaler",
                            daemon=True)
    prompts = _lm_prompts(get_config("internlm2-1.8b").vocab)
    counts, frames, lock = {}, [], threading.Lock()
    orig = ClusterRequest.complete

    def counting(req, result, replica_rid):
        with lock:
            counts[id(req)] = counts.get(id(req), 0) + 1
        return orig(req, result, replica_rid)

    def on_partial(frame):
        if isinstance(frame, tuple) and frame and isinstance(frame[0], list):
            with lock:
                frames.append((time.monotonic(), len(frame[0])))

    try:
        t_spawn = time.perf_counter()
        router.add_replica(spec=spec, cfg=rcfg, transport="process")
        first_s = time.perf_counter() - t_spawn
        warm = router.submit((prompts[0][:40], 8), timeout_s=120.0)
        check(router.wait(warm, 180.0) is not None and
              warm.status is Status.OK, "telemetry: warm-up failed")
        sampler.start()
        server = StatsServer(router.cluster_snapshot, store, slo=slo,
                             port=0).start()
        loop.start()
        reqs = []
        t_burst = time.monotonic()
        with mock.patch.object(ClusterRequest, "complete", counting):
            for i in range(BURST_REQUESTS):
                reqs.append(router.submit(
                    (prompts[i % len(prompts)], CLUSTER_NEW - 1),
                    cost=CLUSTER_NEW, timeout_s=600.0,
                    on_partial=on_partial))
                time.sleep(BURST_GAP_S)
            t_arrived = time.monotonic()
            outs = [router.wait(q, 600.0) for q in reqs]
        t_done = time.monotonic()
        check(all(q.status is Status.OK and isinstance(o, list) and
                  len(o) == CLUSTER_NEW and counts.get(id(q)) == 1
                  for q, o in zip(reqs, outs)),
              f"telemetry burst: statuses {[q.status for q in reqs]}, "
              f"completions {[counts.get(id(q)) for q in reqs]}")
        ups = [(ev, s, t) for ev, s, t in ticks if ev.action == "up"]
        check(any(t < t_done for _, _, t in ups),
              f"telemetry: no replica was added while the burst lasted: "
              f"{[(e.action, e.n_replicas, e.reason) for e, _, _ in ticks]}")
        deadline = time.monotonic() + 90.0
        while router.n_alive() > SCALER["min_replicas"] and \
                time.monotonic() < deadline:
            time.sleep(0.25)
        check(any(ev.action == "down" for ev, _, _ in ticks) and
              router.n_alive() == SCALER["min_replicas"],
              f"telemetry: the idle pool was not drained: "
              f"{[(ev.action, ev.n_replicas) for ev, _, _ in ticks]}")
        stop.set()
        loop.join(60.0)
        check(not loop.is_alive(), "telemetry: the scaler loop hangs")
        sampler.tick()
        prom, ts, slo_doc = _fetch_routes(server)
    finally:
        stop.set()
        sampler.stop()
        if server is not None:
            server.stop()
        router.stop()
    launched = {k: prom.get(f"repro_kernels_launches_{k}", 0.0)
                for k in DENSE_KERNELS}
    check(all(v > 0 for v in launched.values()),
          f"/metrics: kernel launches {launched}")
    used, _ = _worker_launches(router, DENSE_KERNELS)
    ready = ups[0][2]

    def tok_s(a, b):
        n = sum(k for t, k in frames if a <= t < b)
        return n / (b - a) if b > a else float("nan")

    served = {}
    for q in reqs:
        served[q.replica_rid] = served.get(q.replica_rid, 0) + 1
    events = "; ".join(
        f"{ev.action} to {ev.n_replicas} at +{ev.t - t_burst:.2f}s "
        f"({ev.reason}; the tick took {s:.2f}s)" for ev, s, _ in ticks)
    alerts = {sub: (a["state"], a["fired_count"])
              for o in slo_doc["objectives"] for sub, a in o["alerts"].items()}
    print(f"[telemetry burst] internlm2-1.8b full width, dense, process "
          f"replicas behind a least-loaded Router; the first ready in "
          f"{first_s:.1f}s; {len(reqs)} requests of "
          f"{min(CLUSTER_PROMPTS)}-{max(CLUSTER_PROMPTS)} prompt tokens, "
          f"{CLUSTER_NEW} new tokens each, one every {BURST_GAP_S}s "
          f"(arrivals over {t_arrived - t_burst:.2f}s, done at "
          f"+{t_done - t_burst:.2f}s): all OK, each completed exactly once; "
          f"served by replica {served}; scale events: {events}")
    print(f"[telemetry burst] tok/s from the token frames: "
          f"{tok_s(t_burst, ready):.1f} before the first new replica was "
          f"ready (+{ready - t_burst:.2f}s), {tok_s(ready, t_done):.1f} "
          f"after it, {tok_s(t_burst, t_done):.1f} over the burst; worker "
          f"launches {used}")
    print(f"[telemetry routes] /metrics {len(prom)} samples, kernel "
          f"launches {launched}; /timeseries.json {ts['n_keys']} keys, "
          f"{ts['n_points']}/{ts['max_points']} points, arrival EWMA "
          f"{ts['gauges'].get('timeseries.arrival_rate_hz', {}).get('ewma')}"
          f"; /slo.json {slo_doc['ticks']} ticks, alerts {alerts}, pressure "
          f"{slo_doc['pressure']:.3f}; /dash parsed; sampler ticks "
          f"{sampler.ticks}; bodies in {OUT_DIR.name}/")


def _telemetry_overhead():
    """The sampler's cost: one full-width internlm2-1.8b dense engine in
    this process serves phase 6's 16 requests four times, with the serve
    driver's stats stack (``--stats-period 0.25``, the sampler over the
    engine's registry, the SLO engine) off, on, on, off; tok/s of each."""
    import argparse
    import gc

    import torch
    from repro_torch.cluster import MetricsRegistry
    from repro_torch.cluster.backends import make_engine
    from repro_torch.launch import serve
    dev = torch.device("cuda", 0)
    metrics = MetricsRegistry()
    eng = make_engine(device=dev, paged=False, metrics=metrics, **CLUSTER_LM)
    prompts = _lm_prompts(eng.cfg.vocab)
    _drain(eng, [prompts[0][:40]], 8)
    args = argparse.Namespace(stats_period=STATS_PERIOD_S, stats_port=None,
                              stats_dump=None, stats_host="127.0.0.1",
                              watch=False)
    runs = []
    for on in (False, True, True, False):
        finalize = serve._start_telemetry(args, metrics.snapshot, metrics) \
            if on else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = _drain(eng, prompts, CLUSTER_NEW - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if finalize is not None:
            finalize()
        check(all(len(r.out_tokens) == CLUSTER_NEW for r in reqs),
              "telemetry overhead: short requests")
        runs.append((on, sum(r.decoded for r in reqs) / wall))
    off = [r for on, r in runs if not on]
    on_ = [r for on, r in runs if on]
    print(f"[telemetry overhead] one dense engine, {len(prompts)} requests x "
          f"{CLUSTER_NEW} tokens, the stats stack off/on/on/off: tok/s "
          + ", ".join(f"{'on' if on else 'off'} {r:.1f}" for on, r in runs)
          + f"; mean on / mean off = {sum(on_) / sum(off):.4f}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _telemetry_driver():
    """``python -m repro_torch.launch.serve --stats-dump PREFIX`` at its
    defaults (full-width internlm2-1.8b on the card) in a process of its
    own: it prints its ``[stats]`` and ``[serve]`` lines and the four
    files parse."""
    import os
    OUT_DIR.mkdir(exist_ok=True)
    prefix = OUT_DIR / "chip_smoke_serve_stats"
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--requests", "8",
         "--stats-dump", str(prefix)], cwd=ROOT, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    wall = time.perf_counter() - t0
    lines = out.stdout.strip().splitlines()
    check(out.returncode == 0 and lines and lines[-1].startswith("[serve]")
          and any(ln.startswith("[stats] dumped 4 routes") for ln in lines),
          f"serve --stats-dump: rc {out.returncode}, stdout {out.stdout!r}, "
          f"stderr {out.stderr[-2000:]!r}")
    for name in ("timeseries", "slo"):
        json.loads(Path(f"{prefix}.{name}.json").read_text())
    metrics = Path(f"{prefix}.metrics.txt").read_text()
    check("repro_engine_tokens" in metrics and
          Path(f"{prefix}.dash.html").read_text().startswith("<!DOCTYPE"),
          "serve --stats-dump: the dumped routes")
    print(f"[telemetry driver] python -m repro_torch.launch.serve "
          f"--requests 8 --stats-dump: {lines[-1]} (process wall "
          f"{wall:.1f}s); 4 routes dumped and parsed")


# ----------------------------------------------------------------------
# the train phase: the reduced check's steps and schedule, and the full-
# width run's (internlm2-1.8b, bf16 parameters, remat none)
TRAIN_LR, TRAIN_WARMUP, TRAIN_TOTAL = 1e-2, 1, 10
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_RESUME = \
    4, 1024, 8, 4, 4
# kernels against plain on the reduced fp32 model, 3 steps: the losses,
# grad norms and lr within TRAIN_RTOL; the moments within TRAIN_RTOL of
# each leaf's largest magnitude; the parameters within 1e-3 * lr (Adam
# moves an element by lr times m/sqrt(v), a ratio that is noise where the
# element's gradient cancels: tests/test_torch_train.py's rule at a
# looser rtol for the card's other orders of summation)
TRAIN_RTOL = 1e-4


def phase_train(smi):
    """Training on the card (``launch/steps.py``, ``launch/train.py``):
    (a) reduced fp32 internlm2-1.8b two layers deep at head dim 64, 3 steps
    through the kernels and the same 3 through the plain versions; (b)
    internlm2-1.8b at full width through ``launch/train.py``'s ``train``,
    (d) the dry run of one more step against it, its step-4 checkpoint
    resumed; (c) a scan that requires grad raises.
    Returns the launches of (b)."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    _train_reduced()
    launches = _train_full_width(smi)
    _train_refusal()
    return launches


def _train_reduced():
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten_with_paths
    dev = torch.device("cuda", 0)
    # head dim 64: the reduced config's 16 is a backward the card has too
    # (phase 2), but 64 gives its 4 heads the tensor-core tiles of a model
    cfg, params0 = _reduced_two_layers("internlm2-1.8b", head_dim=64)
    rng = np.random.RandomState(5)
    toks = [torch.from_numpy(rng.randint(0, cfg.vocab, (4, 128)).astype(
        np.int32)).to(dev) for _ in range(3)]
    runs = {}
    for plain in (False, True):
        ops.reset_counts()
        fn = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                   total=TRAIN_TOTAL)
        params, opt, hist = params0, adamw_init(params0), []
        with _forced_plain(plain):
            (_, _), grads = steps.value_and_grad(params, cfg,
                                                  {"tokens": toks[0]})
            for tok in toks:
                params, opt, m = fn(params, opt, {"tokens": tok})
                hist.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        flat = flatten_with_paths(grads)
        check(all(bool(torch.isfinite(g).all()) and bool((g != 0).any())
                  for g in flat.values()),
              f"train (a) {'plain' if plain else 'kernel'}: a gradient is "
              f"zero or not finite: "
              f"{[k for k, g in flat.items() if not (g != 0).any()]}")
        runs[plain] = (hist, flatten_with_paths(params),
                       flatten_with_paths(opt.m), flatten_with_paths(opt.v),
                       dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS))
    (kh, kp, km, kv, kl, _), (ph, pp, pm, pv, pl, pc) = runs[False], \
        runs[True]
    check(kl["flash_attention"] == 2 * 4 and
          kl["flash_attention_bwd"] == 2 * 4 and sum(pl.values()) == 0 and
          pc["flash_attention"] == 2 * 4,
          f"train (a): kernel launches {kl}, plain launches {pl}, plain "
          f"calls {pc}")
    worst = {}
    for key in ("loss", "ce", "grad_norm", "lr"):
        worst[key] = max(abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                         for a, b in zip(kh, ph))
    check(max(worst.values()) <= TRAIN_RTOL,
          f"train (a): kernel vs plain metrics off by {worst} (relative, "
          f"limit {TRAIN_RTOL})")
    off = {}
    for label, got, want, atol in (
            ("params", kp, pp, lambda w: 1e-3 * TRAIN_LR),
            ("m", km, pm, lambda w: TRAIN_RTOL * w.abs().max().item()),
            ("v", kv, pv, lambda w: TRAIN_RTOL * w.abs().max().item())):
        for k, w in want.items():
            ok = torch.allclose(got[k], w, rtol=TRAIN_RTOL, atol=atol(w))
            check(ok, f"train (a): {label} {k} kernel vs plain off by "
                      f"{(got[k] - w).abs().max().item():.3e}")
        off[label] = max((got[k] - w).abs().max().item()
                         for k, w in want.items())
    print(f"[train] (a) reduced fp32 internlm2-1.8b, 2 layers, hd 64, B 4 x "
          f"S 128, 3 AdamW steps (lr {TRAIN_LR}, warmup {TRAIN_WARMUP}): "
          f"losses {[round(h['loss'], 6) for h in kh]} through the kernels "
          f"({kl['flash_attention']} flash forward and "
          f"{kl['flash_attention_bwd']} backward launches) and "
          f"{[round(h['loss'], 6) for h in ph]} through the plain versions; "
          f"relative gaps {', '.join(f'{k} {v:.2e}' for k, v in worst.items())}"
          f" (limit {TRAIN_RTOL}); max |gap| params {off['params']:.2e} "
          f"(limit {1e-3 * TRAIN_LR:.0e} + {TRAIN_RTOL} of each), m "
          f"{off['m']:.2e}, v {off['v']:.2e} (limits {TRAIN_RTOL} of each "
          f"leaf's largest + {TRAIN_RTOL} of each); every gradient finite "
          f"and non-zero")


def _train_full_width(smi):
    """internlm2-1.8b at full width through ``train``: bf16 parameters,
    remat none, B 4 x S 1024 from synthetic_tokens, 8 AdamW steps with a
    checkpoint at step 4; exactly 24 x 8 flash forward and backward
    launches; (d) the dry run of one more step against that step on the
    card; then a run resumed from the step-4 checkpoint, whose first
    step (5) must give step 5's loss bit for bit."""
    import gc
    import shutil
    import tempfile

    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.tree import tree_leaves
    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2-1.8b")
    check(cfg.remat == "none" and cfg.param_dtype == "bfloat16",
          f"internlm2-1.8b: remat {cfg.remat}, params {cfg.param_dtype}")
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S,
              warmup=2, ckpt_every=TRAIN_CKPT_EVERY, device=dev)

    def show(rec):
        print(f"[train] (b) step {rec['step']}: loss={rec['loss']:.6f} "
              f"grad_norm={rec['grad_norm']:.4f} lr={rec['lr']:.3e} "
              f"ms={rec['ms']:.1f}", flush=True)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    held = torch.cuda.memory_allocated() / 2 ** 30
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t0 = time.perf_counter()
        run = train(cfg, ckpt_dir=str(tmp / "run"), on_step=show, **kw)
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        hist = run["history"]
        n_layers = cfg.n_layers
        check(launches["flash_attention"] == n_layers * TRAIN_STEPS and
              launches["flash_attention_bwd"] == n_layers * TRAIN_STEPS and
              sum(launches.values()) == 2 * n_layers * TRAIN_STEPS and
              not any(ops.PLAIN_CALLS.values()),
              f"train (b): launches {launches}, plain calls "
              f"{ops.PLAIN_CALLS}; want {n_layers * TRAIN_STEPS} flash "
              f"forward and backward each")
        check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                  for h in hist), f"train (b): non-finite metrics {hist}")
        check(hist[0]["lr"] == 0.0, f"train (b): step 0's lr {hist[0]['lr']}")
        steady = hist[1:]
        tok_s = TRAIN_B * TRAIN_S * len(steady) / (
            sum(h["ms"] for h in steady) / 1e3)
        params = sum(p.numel() for p in tree_leaves(run["params"]))
        busy_ms = _profile_train_step(cfg, run["params"], run["opt"], dev)
        _train_dry_run(cfg, run["params"], run["opt"], dev, smi, busy_ms)
        del run
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[train] (b) internlm2-1.8b full width ({params:,} "
              f"parameters, bf16; fp32 moments), B {TRAIN_B} x S {TRAIN_S}, "
              f"remat none, {TRAIN_STEPS} steps in {wall:.1f}s (init, "
              f"checkpoints at steps {TRAIN_CKPT_EVERY} and {TRAIN_STEPS} "
              f"and the final wait included): {tok_s:,.0f} tokens/s over "
              f"steps 1-{TRAIN_STEPS - 1} (step 0: {hist[0]['ms']:.1f} ms), "
              f"peak {peak:.2f} GiB allocated ({held:.2f} GiB held before "
              f"the run); launches: flash forward "
              f"{launches['flash_attention']}, backward "
              f"{launches['flash_attention_bwd']} ({n_layers} layers x "
              f"{TRAIN_STEPS} steps)")
        # a run cut after the step-4 checkpoint: that step alone in a new
        # directory, LATEST at 4
        resume = tmp / "resume"
        resume.mkdir()
        shutil.move(str(tmp / "run" / f"step_{TRAIN_RESUME}"),
                    str(resume / f"step_{TRAIN_RESUME}"))
        (resume / "LATEST").write_text(str(TRAIN_RESUME))
        shutil.rmtree(tmp / "run")
        t0 = time.perf_counter()
        again = train(cfg, ckpt_dir=str(resume), **kw)["history"]
        first, want = again[0], hist[TRAIN_RESUME + 1]
        check(first["step"] == want["step"] and
              first["loss"] == want["loss"],
              f"train (b): resumed from step {TRAIN_RESUME}'s checkpoint, "
              f"step {first['step']} loss {first['loss']!r} != the "
              f"uninterrupted run's {want['loss']!r}")
        later = [a["loss"] == b["loss"] for a, b in
                 zip(again[1:], hist[TRAIN_RESUME + 2:])]
        print(f"[train] (b) resumed from the step-{TRAIN_RESUME} checkpoint "
              f"({TRAIN_RESUME + 1} updates) in "
              f"{time.perf_counter() - t0:.1f}s: step {want['step']} loss "
              f"{first['loss']!r}, bit for bit the uninterrupted run's; "
              f"steps {[a['step'] for a in again[1:]]} equal too: {later}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"flash_attention_bwd": launches["flash_attention_bwd"]}


#: phase 9 (d): the dry run's temp bytes against the card's peak increase
DRY_TEMP_REL = 0.05


def _train_dry_run(cfg, params, opt, dev, smi, busy_ms):
    """(d) ``launch/dryrun_lib.run_cell`` of this step (B 4 x S 1024, the
    config trained, a 1 x 1 mesh under broadcast) on fake tensors, nothing
    allocated and nothing launched on the card; then one more step timed
    alone and one under ``dryrun_lib.counting``, each after
    ``reset_peak_memory_stats``.  The dry run's FLOPs and each kernel's
    calls (its ``LAST_OPS``' ``kernel:`` rows) must equal the counted
    step's, whose launches ``kernels.LAUNCHES`` and the counter both
    count; its args the bytes of the step's inputs on the card, and its
    temp bytes be within DRY_TEMP_REL of each step's peak increase over
    the allocation before it (the step alone too: a reference cycle that
    held a tree's tensors until Python's cyclic collector ran put it
    3.78 GB above the counted step, whose Python work ran the collector
    sooner).  The roofline terms, the step's share of the bf16 peak and
    the eager per-op bytes over the step's time are printed, not gated,
    over the step alone on the host clock and over ``busy_ms``, the
    device's busy time in phase 9's profiled step."""
    import gc

    import torch
    from repro_torch import kernels
    from repro_torch.configs.base import ShapeCase
    from repro_torch.core import flags
    from repro_torch.data.text import synthetic_tokens
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun_lib, steps
    from repro_torch.launch.mesh import abstract_mesh
    from repro_torch.tree import tree_leaves
    sc = ShapeCase("phase9", TRAIN_S, TRAIN_B, "train")
    mesh = abstract_mesh((1, 1), ("data", "model"), rank0=True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    ops.reset_counts()
    t0 = time.perf_counter()
    res = dryrun_lib.run_cell(cfg.name, sc, mesh, policy="broadcast",
                              cfg_override={"remat": cfg.remat})
    dry_s = time.perf_counter() - t0
    dry_launches = {k.split(":", 1)[1]: int(r[0])
                    for k, r in dryrun_lib.LAST_OPS.items()
                    if k.startswith("kernel:")}
    check(res.ok and not res.skipped and res.policy == "broadcast",
          f"train (d): the dry run of phase 9's step: ok={res.ok} policy="
          f"{res.policy} error={res.error!r}")
    check(torch.cuda.memory_allocated(dev) == held,
          f"train (d): the dry run allocated "
          f"{torch.cuda.memory_allocated(dev) - held} bytes on the card")
    check(not any(kernels.LAUNCHES.values()),
          f"train (d): the dry run counted launches on the card: "
          f"{kernels.LAUNCHES}")
    tok = torch.from_numpy(next(itertools.islice(synthetic_tokens(
        0, TRAIN_B, TRAIN_S, cfg.vocab, TRAIN_STEPS + 3), TRAIN_STEPS + 2,
        None))).to(dev)
    batch = {"tokens": tok}
    args = tree_leaves((params, opt, batch))
    check(not any(flags.counted(t) for t in args),
          "train (d): a live input takes the count route")
    resident = sum(t.numel() * t.element_size() for t in args)
    fn = steps.make_train_step(cfg)
    runs = {}
    for label in ("alone", "counted"):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_counts()
        ctx = dryrun_lib.counting() if label == "counted" else \
            contextlib.nullcontext((None, None))
        with ctx as (fc, c):
            t0 = time.perf_counter()
            new = fn(params, opt, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        m = {k: float(v) for k, v in new[2].items()}
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]),
              f"train (d): step {label}: metrics {m}")
        runs[label] = dict(ms=ms, peak=torch.cuda.max_memory_allocated(dev)
                           - base, base=base,
                           launches={k: v for k, v in kernels.LAUNCHES.items()
                                     if v})
        if c is not None:
            runs[label].update(flops=dryrun_lib.step_flops(fc, c),
                               tracked=c.peak_bytes, kernels=c.launches())
        del new
    live, alone = runs["counted"], runs["alone"]
    gap = abs(res.temp_bytes_dev - live["peak"]) / live["peak"]
    gap_alone = abs(res.temp_bytes_dev - alone["peak"]) / alone["peak"]
    print(f"[train] (d) dry run of this step (B {TRAIN_B} x S {TRAIN_S}, "
          f"1x1 mesh, broadcast, {dry_s:.1f}s on fake tensors, nothing "
          f"allocated or launched on the card) against one counted step on "
          f"{smi}: FLOPs {res.flops_dev:.6e} / {live['flops']:.6e}; kernel "
          f"calls {dry_launches} / launches on the card {live['launches']} "
          f"(the counter's: {live['kernels']}); args {res.arg_bytes_dev:,} B "
          f"/ the inputs on the card {resident:,} B (memory_allocated "
          f"before the step {live['base']:,} B); temp "
          f"{res.temp_bytes_dev:,} B / peak increase {live['peak']:,} B, "
          f"off by {gap:.4%} (limit {DRY_TEMP_REL:.0%}; the tracker on the "
          f"card's own tensors {live['tracked']:,} B; the step alone "
          f"{alone['peak']:,} B, off by {gap_alone:.4%}); out "
          f"{res.out_bytes_dev:,} B", flush=True)
    step_ms = alone["ms"]
    print(f"[train] (d) roofline of the step on {smi}: t_compute "
          f"{res.t_compute * 1e3:.3f} ms (bf16 peak), t_memory "
          f"{res.t_memory * 1e3:.3f} ms (the eager per-op bytes "
          f"{res.bytes_dev:.6e} over the HBM rate: an upper bound on the "
          f"traffic, not a measure of it), t_collective "
          f"{res.t_collective * 1e3:.3f} ms, dominant {res.dominant}; the "
          f"step alone {step_ms:.2f} ms on the host clock (counted "
          f"{live['ms']:.2f} ms), {busy_ms:.2f} ms device busy in the "
          f"profiled step: t_compute / step = "
          f"{res.t_compute * 1e3 / step_ms:.4f} of the bf16 peak "
          f"({res.t_compute * 1e3 / busy_ms:.4f} of the "
          f"busy time); eager per-op bytes over the step's time = "
          f"{res.t_memory * 1e3 / step_ms:.4f} of the HBM rate "
          f"({res.t_memory * 1e3 / busy_ms:.4f} over the busy time); useful "
          f"ratio {res.useful_ratio:.4f}", flush=True)
    check(res.flops_dev == live["flops"],
          f"train (d): the dry run counts {res.flops_dev!r} FLOPs, the "
          f"step on the card {live['flops']!r}")
    check(dry_launches == live["launches"] == live["kernels"] and
          dry_launches == {"flash_attention": cfg.n_layers,
                           "flash_attention_bwd": cfg.n_layers},
          f"train (d): kernel calls {dry_launches} dry, launches "
          f"{live['launches']} on the card, {live['kernels']} counted")
    check(res.arg_bytes_dev == resident,
          f"train (d): args {res.arg_bytes_dev} B dry, {resident} B on the "
          f"card")
    check(max(gap, gap_alone) <= DRY_TEMP_REL,
          f"train (d): temp {res.temp_bytes_dev} B dry against a peak "
          f"increase of {live['peak']} B counted and {alone['peak']} B "
          f"alone on the card: off by {gap:.4%} and {gap_alone:.4%}, limit "
          f"{DRY_TEMP_REL:.0%}")


def _profile_train_step(cfg, params, opt, dev):
    """One more full-width step (the run's next batch) timed on the host
    clock, then one under ``torch.profiler``: device busy and idle share,
    device ms by kind of kernel.  Returns the device's busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.text import synthetic_tokens
    from repro_torch.launch import steps
    fn = steps.make_train_step(cfg, warmup=2, total=TRAIN_STEPS)
    tok = [torch.from_numpy(t).to(dev) for t in itertools.islice(
        synthetic_tokens(0, TRAIN_B, TRAIN_S, cfg.vocab, TRAIN_STEPS + 2),
        TRAIN_STEPS, None)]
    walls = []
    for i, prof_on in enumerate((False, True)):
        ctx = profile(activities=[ProfilerActivity.CUDA]) if prof_on else \
            contextlib.nullcontext()
        torch.cuda.synchronize()
        with ctx as prof:
            t0 = time.perf_counter()
            new = fn(params, opt, {"tokens": tok[i]})
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        del new
    busy_us, rows, top = _device_time(prof, "train_step")
    print(f"[profile train step] internlm2-1.8b full width, B {TRAIN_B} x S "
          f"{TRAIN_S}: unprofiled wall={walls[0]:.2f}ms; profiled wall="
          f"{walls[1]:.2f}ms device_busy={busy_us / 1e3:.2f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / walls[1]):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; device ms by kind: "
          f"{_train_kinds(rows)}; top: {top}")
    return busy_us / 1e3


def _train_refusal():
    """(c) the selective scan has no backward kernel: an input that
    requires grad raises on the card, naming its item."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda", 0)
    g = lambda *s: torch.rand(*s, device=dev).requires_grad_(True)  # noqa
    raised = None
    try:
        ops.ssm_scan(g(1, 3, 4), g(1, 3, 4), g(1, 3, 2), g(1, 3, 2),
                     -g(4, 2), g(4))
    except NotImplementedError as e:
        raised = str(e)
    check(raised is not None and "Queue 2, item 9" in raised,
          f"train (c): ssm_scan on inputs that require grad gave {raised!r}")
    print(f"[train] (c) ops.ssm_scan on inputs that require grad raises: "
          f"{raised}")


# ----------------------------------------------------------------------
# whisper-base, the encoder-decoder family
WHISPER_LAYERS = 2           # each side of the reduced config
WHISPER_REDUCED_T = 100      # frames of the reduced runs (not a tile's
                             #   multiple, and not the prompt's length)
# Whisper's start-of-transcript sequence: <|startoftranscript|>, <|en|>,
# <|transcribe|>, <|notimestamps|> (the multilingual vocabulary's ids)
WHISPER_SOT = (50258, 50259, 50359, 50363)
WHISPER_SERVES = ((8, 4, 64), (4, 224, 32))   # (B, prompt, new tokens)
WHISPER_PARAMS = 97_318_912
# The fp32 prefill's last logits on the card (kernels) against the same
# weights' fp32 plain run on the CPU: 12 layers of fp32 sums in another
# order over logits of magnitude ~4 (PERF.md, section 6, predicted before
# the first run)
WHISPER_FP32_ATOL = 1e-3
WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS = 8, 448, 6


def _whisper_reduced(**over):
    """The fp32 reduced whisper-base, WHISPER_LAYERS deep on each side, and
    its seeded weights on the card."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.weights import init_params
    dev = torch.device("cuda", 0)
    n = WHISPER_LAYERS
    cfg = reduced(get_config("whisper-base")).replace(
        enc_layers=n, dec_layers=n, n_layers=2 * n, **over)
    return cfg, init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)


def _whisper_greedy(params, cfg, frames, prompt, new, max_len):
    """Prefill and ``new - 1`` greedy decode steps through
    ``steps.make_prefill_step`` / ``make_decode_step``, nothing read back
    to the host on the way: (tokens (B, new), [logits of each step],
    events (start, after the prefill, end), finite), where ``finite`` is
    a device bool of every logit."""
    import torch
    from repro_torch.launch import steps
    from repro_torch.models import api
    B, S = prompt.shape
    dev = prompt.device
    caches = api.init_caches(cfg, B, max_len, frames.shape[1], device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    decode = steps.make_decode_step(cfg)
    with torch.no_grad():
        ev[0].record()
        logits, caches = steps.make_prefill_step(cfg, max_len)(
            params, {"frames": frames, "tokens": prompt}, caches)
        ev[1].record()
        seen, finite = [logits], torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1).to(torch.int32)
        out = [tok]
        for i in range(new - 1):
            pos = torch.full((B,), S + i, dtype=torch.int32, device=dev)
            logits, caches = decode(params, {"tokens": tok[:, None],
                                             "pos": pos}, caches)
            finite = finite & torch.isfinite(logits).all()
            seen.append(logits)
            tok = logits[:, -1].argmax(-1).to(torch.int32)
            out.append(tok)
        ev[2].record()
    return torch.stack(out, 1), seen, ev, finite


def _token_exact_whisper():
    """The fp32 reduced whisper-base (2 + 2 layers, 100 frames, prompts of
    5 tokens), greedy for 8 tokens through the prefill and decode steps on
    the kernels and forced through the plain versions: the same tokens,
    every step's logits within 1e-4."""
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    cfg, params = _whisper_reduced()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    frames = torch.randn((2, WHISPER_REDUCED_T, cfg.d_model), generator=gen,
                         device=dev)
    prompt = torch.randint(0, cfg.vocab, (2, 5), generator=gen, device=dev,
                           dtype=torch.int32)
    runs = {}
    for plain in (False, True):
        ops.reset_counts()
        with _forced_plain(plain):
            tok, seen, _, _ = _whisper_greedy(params, cfg, frames, prompt, 8,
                                              32)
        torch.cuda.synchronize()
        runs[plain] = (tok, seen, dict(kernels.LAUNCHES),
                       dict(ops.PLAIN_CALLS))
    (kt, ks, kl, kc), (pt, ps, pl, pc) = runs[False], runs[True]
    n_flash, n_dec = 3 * WHISPER_LAYERS, 2 * WHISPER_LAYERS * 7
    want = {"flash_attention": n_flash, "decode_attention": n_dec}
    check({k: v for k, v in kl.items() if v} == want and
          not any(kc.values()) and not any(pl.values()) and
          {k: v for k, v in pc.items() if v} == want,
          f"token-exact whisper: kernel launches {kl}, plain calls {kc}; "
          f"forced plain: launches {pl}, plain calls {pc}; want {want}")
    check(torch.equal(kt, pt), f"token-exact whisper: kernel tokens "
          f"{kt.tolist()} != plain {pt.tolist()}")
    gap = max((a - b).abs().max().item() for a, b in zip(ks, ps))
    check(gap <= 1e-4, f"token-exact whisper: logits off by {gap:.3e} "
          f"(limit 1e-4)")
    print(f"[token-exact] fp32 reduced whisper-base ({WHISPER_LAYERS} + "
          f"{WHISPER_LAYERS} layers, {WHISPER_REDUCED_T} frames, prompts of "
          f"5): the same 8 x 2 tokens through the kernels ({n_flash} flash, "
          f"{n_dec} split-K decode launches) and the plain versions; logits "
          f"within {gap:.2e} (limit 1e-4)")


def phase_whisper():
    """whisper-base at full width: (a) the serve through the prefill and
    decode steps, (b) training through ``steps.make_train_step``."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    _whisper_serve()
    _train_reduced_whisper()
    _whisper_train()
    gc.collect()
    torch.cuda.empty_cache()


def _whisper_inputs(cfg, B, S, dev, seed):
    """Seeded fp32 stub frames (B, 1,500, d_model) and prompts of S tokens:
    Whisper's start-of-transcript sequence, then seeded tokens."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.randn((B, WHISPER_T, cfg.d_model), generator=gen,
                         device=dev)
    sot = torch.tensor(WHISPER_SOT, dtype=torch.int32, device=dev)
    rest = torch.randint(0, cfg.vocab, (B, S - len(WHISPER_SOT)),
                         generator=gen, device=dev, dtype=torch.int32)
    return frames, torch.cat([sot.expand(B, -1), rest], 1)


def _whisper_serve():
    """(a) B 8 requests of 1,500 frames with Whisper's 4-token prompt, 64
    greedy tokens, max_len 448; then B 4 with 224-token prompts, 32
    tokens; bf16 weights; each timed after an untimed warm-up at its
    shapes.  Exact launches (18 flash a prefill, 12 split-K
    decode a step, nothing else), every logit finite; the fp32 prefill on
    the card against the same weights' fp32 plain run on the CPU; the bf16
    tokens' agreement with an fp32 kernel serve (printed, not a gate)."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import api, encdec
    from repro_torch.tree import tree_leaves, tree_map
    dev = torch.device("cuda", 0)
    cfg = get_config("whisper-base")
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    check(n_params == WHISPER_PARAMS, f"whisper-base: {n_params:,} "
          f"parameters, want {WHISPER_PARAMS:,}")
    n_enc, n_dec = cfg.enc_layers, cfg.dec_layers
    for B, S, new in WHISPER_SERVES:
        frames, prompt = _whisper_inputs(cfg, B, S, dev, seed=B)
        # one untimed prefill and decode step first, so that the timed run
        # meets no shape for the first time; then the encoder alone
        _whisper_greedy(params, cfg, frames, prompt, 2, WHISPER_MAX_LEN)
        with torch.no_grad():
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
            encdec.encode(params, frames, cfg)
            e1.record()
        torch.cuda.synchronize()
        enc_ms = e0.elapsed_time(e1)
        ops.reset_counts()
        tok, seen, ev, finite = _whisper_greedy(params, cfg, frames, prompt,
                                                new, WHISPER_MAX_LEN)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = {"flash_attention": 3 * n_dec,
                "decode_attention": 2 * n_dec * (new - 1)}
        check(launches == want and not any(ops.PLAIN_CALLS.values()),
              f"whisper serve B {B}: launches {launches}, plain calls "
              f"{ops.PLAIN_CALLS}; want {want} ({n_enc} bidirectional + "
              f"{n_dec} causal + {n_dec} cross flash a prefill, {2 * n_dec} "
              f"split-K decodes a step)")
        check(bool(finite), f"whisper serve B {B}: a bf16 logit is not "
              f"finite")
        pre_ms, dec_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
        step_ms = dec_ms / (new - 1)
        print(f"[whisper] (a) serve B {B} x ({WHISPER_T} frames, prompt "
              f"{S}), {new} greedy tokens, max_len {WHISPER_MAX_LEN}, bf16 "
              f"({n_params:,} parameters): encode_ms={enc_ms:.2f} "
              f"prefill_ms={pre_ms:.2f} (encode included) decode_step_ms="
              f"{step_ms:.3f} tok/s={B * new / ((pre_ms + dec_ms) / 1e3):.0f}"
              f"; launches {launches} (flash {3 * n_dec} a prefill, split-K "
              f"decode {2 * n_dec} a step); every logit finite")
        if B != WHISPER_SERVES[0][0]:
            continue
        # the same requests in fp32: on the card (kernels), and its prefill
        # on the CPU through the plain versions
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        tok32, seen32, _, _ = _whisper_greedy(p32, cfg32, frames, prompt,
                                              new, WHISPER_MAX_LEN)
        agree = (tok32 == tok).float().mean().item()
        first = (tok32 != tok).any(0).nonzero()
        p_cpu = tree_map(lambda t: t.cpu(), p32)
        with torch.no_grad():
            want_cpu, _ = api.prefill_fn(
                p_cpu, cfg32, {"frames": frames.cpu(), "tokens": prompt.cpu()},
                api.init_caches(cfg32, B, WHISPER_MAX_LEN, WHISPER_T,
                                device="cpu"))
        keep = torch.arange(cfg.padded_vocab) < cfg.vocab
        gap = (seen32[0].cpu() - want_cpu)[..., keep].abs().max().item()
        top = want_cpu[..., keep].abs().max().item()
        check(gap <= WHISPER_FP32_ATOL,
              f"whisper fp32 prefill: kernel logits off the CPU plain run by "
              f"{gap:.3e} (limit {WHISPER_FP32_ATOL})")
        print(f"[whisper] (a) fp32 prefill (B {B}) on the card against the "
              f"CPU plain run: max |gap| {gap:.3e} over logits up to "
              f"{top:.2f} (limit {WHISPER_FP32_ATOL}); bf16 tokens agree "
              f"with the fp32 kernel serve's at {agree:.2%} of {B} x {new} "
              f"(first difference at step "
              f"{first[0].item() if len(first) else None}; not a gate)")
        del p32, p_cpu, seen32
    del params


def _train_reduced_whisper():
    """(b) first: the fp32 reduced whisper-base (2 + 2 layers, hd 64) takes
    3 AdamW steps through the kernels and the same 3 through the plain
    versions, as phase 9 (a) holds internlm2."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten_with_paths
    dev = torch.device("cuda", 0)
    cfg, params0 = _whisper_reduced(head_dim=64)
    rng = np.random.RandomState(7)
    batches = [{"frames": torch.from_numpy(rng.randn(
        4, WHISPER_REDUCED_T, cfg.d_model).astype(np.float32)).to(dev),
        "tokens": torch.from_numpy(rng.randint(0, cfg.vocab, (4, 48)).astype(
            np.int32)).to(dev)} for _ in range(3)]
    runs = {}
    for plain in (False, True):
        ops.reset_counts()
        fn = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                   total=TRAIN_TOTAL)
        params, opt, hist = params0, adamw_init(params0), []
        with _forced_plain(plain):
            (_, _), grads = steps.value_and_grad(params, cfg, batches[0])
            for batch in batches:
                params, opt, m = fn(params, opt, batch)
                hist.append({k: float(v) for k, v in m.items()})
        torch.cuda.synchronize()
        flat = flatten_with_paths(grads)
        check(all(bool(torch.isfinite(g).all()) and bool((g != 0).any())
                  for g in flat.values()),
              f"whisper train (b) {'plain' if plain else 'kernel'}: a "
              f"gradient is zero or not finite")
        runs[plain] = (hist, flatten_with_paths(params),
                       flatten_with_paths(opt.m), flatten_with_paths(opt.v),
                       dict(kernels.LAUNCHES), dict(ops.PLAIN_CALLS))
    (kh, kp, km, kv, kl, _), (ph, pp, pm, pv, pl, pc) = runs[False], \
        runs[True]
    n = 4 * 3 * WHISPER_LAYERS        # 4 losses x (enc + dec self + cross)
    check(kl["flash_attention"] == n and kl["flash_attention_bwd"] == n and
          sum(pl.values()) == 0 and pc["flash_attention"] == n,
          f"whisper train (b): kernel launches {kl}, plain launches {pl}, "
          f"plain calls {pc}")
    worst = {key: max(abs(a[key] - b[key]) / max(abs(b[key]), 1e-30)
                      for a, b in zip(kh, ph))
             for key in ("loss", "ce", "grad_norm", "lr")}
    check(max(worst.values()) <= TRAIN_RTOL,
          f"whisper train (b): kernel vs plain metrics off by {worst}")
    for label, got, want, atol in (
            ("params", kp, pp, lambda w: 1e-3 * TRAIN_LR),
            ("m", km, pm, lambda w: TRAIN_RTOL * w.abs().max().item()),
            ("v", kv, pv, lambda w: TRAIN_RTOL * w.abs().max().item())):
        for k, w in want.items():
            check(torch.allclose(got[k], w, rtol=TRAIN_RTOL, atol=atol(w)),
                  f"whisper train (b): {label} {k} kernel vs plain off by "
                  f"{(got[k] - w).abs().max().item():.3e}")
    print(f"[whisper] (b) reduced fp32 whisper-base ({WHISPER_LAYERS} + "
          f"{WHISPER_LAYERS} layers, hd 64), B 4 x ({WHISPER_REDUCED_T} "
          f"frames, 48 tokens), 3 AdamW steps: losses "
          f"{[round(h['loss'], 6) for h in kh]} through the kernels ({n} "
          f"flash forward and backward launches) and "
          f"{[round(h['loss'], 6) for h in ph]} through the plain versions; "
          f"relative gaps "
          f"{', '.join(f'{k} {v:.2e}' for k, v in worst.items())} (limit "
          f"{TRAIN_RTOL}); params, m and v within phase 9 (a)'s limits")


def _train_kinds(rows):
    """Device ms by kind of kernel of a training step's profile rows."""
    kinds = dict.fromkeys(("flash backward", "flash forward", "GEMMs",
                           "elementwise", "reductions", "other"), 0.0)
    for us, _, name in rows:
        low = name.lower()
        kind = ("flash backward" if "flash_bwd" in low else
                "flash forward" if "attention_sm90" in low else
                "GEMMs" if any(k in low for k in ("gemm", "nvjet", "cutlass",
                                                  "xmma")) else
                "reductions" if "reduce" in low else
                "elementwise" if "elementwise" in low or "vectorized" in low
                else "other")
        kinds[kind] += us / 1e3
    return ", ".join(f"{k} {v:.2f}" for k, v in kinds.items())


def _whisper_train():
    """(b) whisper-base at full width through ``steps.make_train_step``:
    bf16 parameters, fp32 moments, remat none, B 8 x (1,500 frames, 448
    tokens), warmup 2, 6 AdamW steps; exactly 18 flash forward and 18
    backward launches a step; one more step profiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    dev = torch.device("cuda", 0)
    cfg = get_config("whisper-base")
    check(cfg.remat == "none" and cfg.param_dtype == "bfloat16",
          f"whisper-base: remat {cfg.remat}, params {cfg.param_dtype}")
    B, S, n_steps = WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    opt = adamw_init(params)
    fn = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=2, total=n_steps)
    gen = torch.Generator(device=dev).manual_seed(11)

    def batch():
        return {"frames": torch.randn((B, WHISPER_T, cfg.d_model),
                                      generator=gen, device=dev),
                "tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                        device=dev, dtype=torch.int32)}

    n_attn = cfg.enc_layers + 2 * cfg.dec_layers
    hist = []
    for step in range(n_steps):
        b = batch()
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        params, opt, m = fn(params, opt, b)
        rec = {k: float(v) for k, v in m.items()}
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check(launches == {"flash_attention": n_attn,
                           "flash_attention_bwd": n_attn} and
              not any(ops.PLAIN_CALLS.values()),
              f"whisper train step {step}: launches {launches}, plain calls "
              f"{ops.PLAIN_CALLS}; want {n_attn} flash forward and backward")
        check(math.isfinite(rec["loss"]) and math.isfinite(rec["grad_norm"]),
              f"whisper train step {step}: {rec}")
        hist.append(rec)
        print(f"[whisper] (b) step {step}: loss={rec['loss']:.6f} grad_norm="
              f"{rec['grad_norm']:.4f} lr={rec['lr']:.3e} ms={rec['ms']:.1f}",
              flush=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = hist[1:]
    tok_s = B * S * len(steady) / (sum(h["ms"] for h in steady) / 1e3)
    b = batch()
    walls = []
    for prof_on in (False, True):
        ctx = profile(activities=[ProfilerActivity.CUDA]) if prof_on else \
            contextlib.nullcontext()
        torch.cuda.synchronize()
        with ctx as prof:
            t0 = time.perf_counter()
            new = fn(params, opt, b)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        del new
    busy_us, rows, top = _device_time(prof, "whisper_train_step")
    print(f"[whisper] (b) whisper-base full width (bf16 parameters, fp32 "
          f"moments, remat none), B {B} x ({WHISPER_T} frames, {S} tokens), "
          f"{n_steps} steps: {tok_s:,.0f} decoder tokens/s over steps "
          f"1-{n_steps - 1} (step 0: {hist[0]['ms']:.1f} ms), peak "
          f"{peak:.2f} GiB allocated; {n_attn} flash forward and backward "
          f"launches a step")
    print(f"[profile whisper train step] B {B} x ({WHISPER_T}, {S}): "
          f"unprofiled wall={walls[0]:.2f}ms; profiled wall={walls[1]:.2f}ms "
          f"device_busy={busy_us / 1e3:.2f}ms idle_share="
          f"{max(0.0, 1 - busy_us / 1e3 / walls[1]):.3f} kernels="
          f"{sum(n for _, n, _ in rows)}; device ms by kind: "
          f"{_train_kinds(rows)}; top: {top}")
    del params, opt


# ----------------------------------------------------------------------
# Phase 11: the multi-device paths, 2 ranks on the one card over gloo
MD_WORLD = 2
MD_TIMEOUT_S = 600
#: data-parallel whisper-base at full width: 2 ranks x B 4 of phase 10's
#: B 8 x (1,500 frames, 448 tokens), 4 AdamW steps, warmup 2; each step's
#: loss and grad norm against a one-rank run of the same B 8 steps within
#: these relative limits (bf16 gradients summed in another order; PERF.md
#: section 5 states them)
MD_DP_STEPS = 4
MD_DP_LOSS_REL = 1e-2
MD_DP_GNORM_REL = 5e-2
#: internlm2-1.8b's sequence-sharded prefill: B 1 x S 4,096 over 2 ranks;
#: against the one-rank prefill of the same tokens: the same greedy token,
#: the last position's logits within MD_SEQ_REL of their largest
#: magnitude, each layer's cache K and V within MD_SEQ_REL of their
#: largest magnitude (bf16)
MD_SEQ_S = 4096
MD_SEQ_REL = 2e-2
#: the fp32 reduced gemma3-4b under seqtp: kernel against plain, and
#: against the one-rank kernel run, at the token-exact runs' logit limit
MD_FP32_TOL = 1e-4


def phase_multidevice():
    """Phase 11: the multi-device paths on 2 ranks spawned on the one card
    (``collectives.spawn``, gloo): (a) the sharded MARGOT step at full
    size, (b) ``ElasticRunner`` 2 -> 1 -> 2, (c) ``compressed_psum``, (d)
    data-parallel training (fp32 reduced, then whisper-base at full width
    against a one-rank run made here first), (e) internlm2-1.8b's
    sequence-sharded prefill, (f) the fp32 reduced gemma3-4b under seqtp.
    Every check runs in the ranks; a rank that fails fails the phase."""
    import gc

    import torch
    from repro_torch.core import collectives
    gc.collect()
    torch.cuda.empty_cache()
    ref = _md_dp_reference()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[multi] {MD_WORLD} ranks spawned on cuda:0 over gloo: NCCL "
          f"refuses two ranks on one card, and gloo moves CUDA tensors "
          f"through the host; the ranks time-slice the card, so nothing "
          f"here is a scaling figure", flush=True)
    t0 = time.perf_counter()
    try:
        collectives.spawn(_md_rank, MD_WORLD, backend="gloo", device="cuda",
                          timeout_s=MD_TIMEOUT_S, args=(ref,))
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 11: {e}")
    print(f"[multi] ranks done in {time.perf_counter() - t0:.1f}s")


def _md_dp_batches(cfg, dev, n):
    """Phase 10's seeded whisper batches: B 8 x (1,500 frames, 448
    tokens)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(11)
    B, S = WHISPER_TRAIN_B, WHISPER_TRAIN_S
    return [{"frames": torch.randn((B, WHISPER_T, cfg.d_model),
                                   generator=gen, device=dev),
             "tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device=dev, dtype=torch.int32)}
            for _ in range(n)]


def _md_dp_reference():
    """One rank, in this process: whisper-base at full width, the
    MD_DP_STEPS steps of (d) on the whole B 8 batches; their losses and
    grad norms."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import adamw_init
    dev = torch.device("cuda", 0)
    cfg = get_config("whisper-base")
    params = api.init(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    opt = adamw_init(params)
    fn = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=2,
                               total=MD_DP_STEPS)
    out = []
    for b in _md_dp_batches(cfg, dev, MD_DP_STEPS):
        params, opt, m = fn(params, opt, b)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    del params, opt
    print(f"[multi] (d) one-rank reference: whisper-base B "
          f"{WHISPER_TRAIN_B}, {MD_DP_STEPS} steps: (loss, grad norm) {out}",
          flush=True)
    return out


def _md_rank(rank, ref):
    """One rank's body: (a) to (f) in order, each timed."""
    import torch
    from repro_torch.launch.mesh import compat_make_mesh
    dev = torch.device("cuda", 0)
    mesh = compat_make_mesh((MD_WORLD,), ("data",))
    check(mesh.device == dev and torch.cuda.current_device() == 0,
          f"rank {rank}: device {mesh.device}, want cuda:0")
    for label, fn in (("a", _md_margot), ("b", _md_elastic),
                      ("c", _md_compressed), ("d", _md_dp),
                      ("e", _md_seqtp_full), ("f", _md_seqtp_reduced)):
        t0 = time.perf_counter()
        fn(rank, mesh, ref)
        torch.cuda.synchronize()
        if rank == 0:
            print(f"[multi] ({label}) wall {time.perf_counter() - t0:.1f}s",
                  flush=True)
    return True


def _md_say(rank, msg):
    print(f"[multi r{rank}] {msg}", flush=True)


def _md_compare_links(label, got, want):
    """Link sets (dicts (claim, evidence) -> score) equal up to pairs
    whose |score| is within PAIR_REL of the largest: the pair score's
    phase-5 rule."""
    limit = PAIR_REL * max(abs(x) for x in [*got.values(), *want.values()])
    only = {p: got.get(p, want.get(p)) for p in got.keys() ^ want.keys()}
    check(all(abs(x) <= limit for x in only.values()),
          f"{label}: links differ beyond |score| {limit:.3e}: "
          f"{list(only.items())[:5]}")
    diff = max(abs(got[p] - want[p]) for p in got.keys() & want.keys())
    check(diff <= limit, f"{label}: common scores differ by {diff:.3e}")
    return len(only), diff, limit


def _md_margot(rank, mesh, ref):
    """(a) DS1 and DS2 (d 1,024, the paper's models) through the sharded
    step: its gathered links against the shard-local oracle computed on
    the card with the plain version; pair-score launches and wall time,
    beside the one-device step on the same rows."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.margot_svm import DATASETS, PIPELINE
    from repro_torch.core import pipeline
    from repro_torch.core.collectives import local_block
    from repro_torch.core.filtering import Compacted
    from repro_torch.data.text import margot_models
    from repro_torch.kernels import ops
    from repro_torch.launch import argmining
    dev = mesh.device
    models = margot_models(PIPELINE, device=dev)
    step = pipeline.make_batch_step(PIPELINE, mesh)
    for ds in ("DS1", "DS2"):
        X, keys, _ = argmining.make_corpus(DATASETS[ds], PIPELINE.feat_dim)
        n = len(X) - len(X) % MD_WORLD
        Xd = torch.from_numpy(X[:n]).to(dev)
        kd = torch.from_numpy(keys[:n]).to(dev)
        Xl, kl = (local_block(t, "data", mesh) for t in (Xd, kd))
        step(models, Xl, kl)
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        out = step(models, Xl, kl)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        check(launches == {"pair_score": 1} and
              not any(ops.PLAIN_CALLS.values()),
              f"(a) {ds} rank {rank}: launches {launches}")
        links = {(c, e): s for c, e, s in pipeline.gather_links(out, mesh)}
        _md_say(rank, f"(a) {ds}: {n} sentences, {n // MD_WORLD} a rank, "
                      f"sharded step wall={wall * 1e3:.2f}ms, pair_score "
                      f"launches={launches['pair_score']} (C_total "
                      f"{out.link_scores.shape[0]} x E_local "
                      f"{out.link_scores.shape[1]}), n_dropped="
                      f"{int(out.n_dropped)}, links={len(links)}")
        if rank:
            continue
        # the shard-local oracle: each shard's compaction, every claim
        # against every evidence, scored by the plain version
        parts = []
        for s in range(MD_WORLD):
            rows = slice(s * (n // MD_WORLD), (s + 1) * (n // MD_WORLD))
            c, e = pipeline._phase1_local(models, Xd[rows], kd[rows],
                                          PIPELINE)
            off = s * (n // MD_WORLD)
            parts.append([x._replace(index=torch.where(
                x.valid, x.index + off, -1)) for x in (c, e)])
        cat = [Compacted(*(torch.cat([p[i][j] for p in parts])
                           for j in range(5)), n_dropped=0)
               for i in range(2)]
        with _forced_plain(True):
            scores, mask = pipeline._phase2_local(models, *cat)
        ok = mask & (scores > PIPELINE.threshold)
        ci, ei = torch.nonzero(ok, as_tuple=True)
        oracle = {(c, e): sc for c, e, sc in zip(
            cat[0].index[ci].tolist(), cat[1].index[ei].tolist(),
            scores[ci, ei].tolist())}
        n_only, diff, limit = _md_compare_links(f"(a) {ds}", links, oracle)
        one = pipeline.make_batch_step(PIPELINE)
        one(models, Xd, kd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(models, Xd, kd)
        torch.cuda.synchronize()
        _md_say(rank, f"(a) {ds}: the gathered links equal the shard-local "
                      f"oracle's {len(oracle)} (plain version on the card; "
                      f"{n_only} pairs in one set only, each |score| <= "
                      f"{limit:.3e}; common scores within {diff:.3e}); the "
                      f"one-device step on all {n} rows: wall="
                      f"{(time.perf_counter() - t0) * 1e3:.2f}ms (phase 5 "
                      f"runs DS1 as 12-document partitions)")


def _md_elastic(rank, mesh, ref):
    """(b) ``ElasticRunner`` over the MARGOT models: placed on 2 ranks
    (rank 0 ships), rescaled to 1 (rank 1 drops its weights) and back to
    2, the links of a batch that drops nothing equal on each mesh."""
    import torch
    from repro_torch.configs.margot_svm import DATASETS, PIPELINE
    from repro_torch.core import pipeline
    from repro_torch.core.broadcast import broadcast_bytes
    from repro_torch.core.collectives import local_block
    from repro_torch.core.fault import ElasticRunner
    from repro_torch.data.text import margot_models
    from repro_torch.launch import argmining
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import svm
    dev = mesh.device
    models = margot_models(PIPELINE, device=dev)
    X, keys, _ = argmining.make_corpus(DATASETS["DS1"], PIPELINE.feat_dim)
    _, hi = argmining.partition_bounds(keys, 12)[0]
    n = hi - hi % MD_WORLD
    Xd, kd = (torch.from_numpy(a[:n]).to(dev) for a in (X, keys))
    held = models if rank == 0 else {
        k: {m: torch.empty_like(t, device="meta") for m, t in v.items()}
        for k, v in models.items()}
    t0 = time.perf_counter()
    runner = ElasticRunner(held, svm.param_axes(models), mesh, "broadcast")
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    check(all(torch.equal(runner.params[k][m], models[k][m])
              for k in models for m in models[k]),
          f"(b) rank {rank}: the shipped models differ from rank 0's")

    def links(m):
        out = pipeline.make_batch_step(PIPELINE, m)(
            runner.params, local_block(Xd, "data", m),
            local_block(kd, "data", m))
        return ({(c, e): s for c, e, s in pipeline.gather_links(out, m)},
                int(out.n_dropped))

    l2, d2 = links(mesh)
    mesh1 = compat_make_mesh((1,), ("data",))
    runner.rescale(mesh1)
    check((runner.params is None) == (rank == 1),
          f"(b) rank {rank}: holds weights {runner.params is not None} on "
          f"the 1-rank mesh")
    s1 = runner.rescale_s
    if rank == 0:
        l1, d1 = links(mesh1)
        check(d2 == 0 and d1 == 0 and l1.keys() == l2.keys(),
              f"(b) n_dropped {d2} on 2 ranks, {d1} on 1; links "
              f"{len(l2)} vs {len(l1)}")
    mesh2 = compat_make_mesh((MD_WORLD,), ("data",))
    runner.rescale(mesh2)
    l2b, _ = links(mesh2)
    check(l2b.keys() == l2.keys() and runner.generation == 2,
          f"(b) rank {rank}: back on 2 ranks: {len(l2b)} links, generation "
          f"{runner.generation}")
    _md_say(rank, f"(b) {n} sentences (12 documents of DS1): n_dropped=0 on "
                  f"2 ranks and on 1, {len(l2)} links on each; placed on 2 "
                  f"in {place_s:.3f}s ({broadcast_bytes(models):,} bytes "
                  f"shipped by rank 0); 2 -> 1 in {s1:.3f}s (rank 1 dropped "
                  f"its weights); 1 -> 2 in {runner.rescale_s:.3f}s "
                  f"({runner.shipped_bytes:,} bytes moved at this rank); "
                  f"generation {runner.generation}")


def _md_compressed(rank, mesh, ref):
    """(c) ``compressed_psum`` of whisper-base-sized fp32 gradients against
    the uncompressed all-reduce, within JAX's quantisation bound."""
    import torch
    from repro_torch.core import collectives
    from repro_torch.optim.compression import compressed_psum, quantize
    dev = mesh.device
    n = WHISPER_PARAMS
    g = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(
        100 + rank), device=dev)
    c, _ = quantize(g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val, raw = compressed_psum(c, "data", mesh)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = collectives.psum(g, "data", mesh)
    torch.cuda.synchronize()
    t_e = time.perf_counter() - t0
    err = float((val - exact).abs().max()) / MD_WORLD
    bound = float(collectives.pmax(g.abs().max(), "data", mesh)) / 127.0
    check(err <= bound and raw.dtype == torch.int32,
          f"(c) rank {rank}: mean off by {err:.3e}, bound {bound:.3e}")
    if rank == 0:
        _md_say(rank, f"(c) compressed_psum of {n:,} fp32 elements a rank: "
                      f"mean within {err:.3e} of the exact all-reduce's "
                      f"(bound max|g|/127 = {bound:.3e}); int8 payload "
                      f"{n + 4:,} bytes a rank against {4 * n:,} fp32 (the "
                      f"gloo reductions move it as int32 and fp32, as JAX's "
                      f"psums do: {8 * n:,} bytes a rank); {t_c:.3f}s "
                      f"against {t_e:.3f}s for the fp32 all-reduce "
                      f"(host-staged)")


def _md_params_hash(params):
    import hashlib
    from repro_torch.tree import flatten_with_paths
    h = hashlib.sha256()
    for v in flatten_with_paths(params).values():
        h.update(v.detach().cpu().view(-1).view(__import__(
            "torch").uint8).numpy().tobytes())
    return h.hexdigest()


def _md_dp(rank, mesh, ref):
    """(d) data parallelism: the fp32 reduced whisper-base, 3 steps on 2
    ranks against the one-rank steps on the whole batch (TRAIN_RTOL);
    then whisper-base at full width, MD_DP_STEPS steps of B 4 a rank
    against ``ref``, the one-rank run of the same B 8 steps."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import collectives
    from repro_torch.core.broadcast import place_params
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import api, weights
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten_with_paths
    dev = mesh.device
    dpm = compat_make_mesh((1, MD_WORLD), ("data", "model"))
    # fp32 reduced: data parallel against one rank
    cfg, params0 = _whisper_reduced(head_dim=64)
    rng = np.random.RandomState(7)
    batches = [{"frames": torch.from_numpy(rng.randn(
        4, WHISPER_REDUCED_T, cfg.d_model).astype(np.float32)).to(dev),
        "tokens": torch.from_numpy(rng.randint(0, cfg.vocab, (4, 48)).astype(
            np.int32)).to(dev)} for _ in range(3)]
    runs = {}
    for label, m in (("dp", dpm), ("one", None)):
        fn = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                                   total=TRAIN_TOTAL, mesh=m)
        params, opt, hist = params0, adamw_init(params0), []
        for b in batches:
            params, opt, mt = fn(params, opt, b)
            hist.append({k: float(v) for k, v in mt.items()})
        runs[label] = (hist, flatten_with_paths(params))
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                for a, b in zip(runs["dp"][0], runs["one"][0])
                for k in ("loss", "grad_norm"))
    pw = max(float((runs["dp"][1][k] - w).abs().max())
             for k, w in runs["one"][1].items())
    check(worst <= TRAIN_RTOL and pw <= 1e-3 * TRAIN_LR,
          f"(d) fp32 reduced rank {rank}: metrics off by {worst:.3e}, "
          f"parameters by {pw:.3e}")
    if rank == 0:
        _md_say(rank, f"(d) fp32 reduced whisper-base, 3 data-parallel "
                      f"steps (2 ranks x B 2): losses and grad norms within "
                      f"{worst:.2e} of the one-rank steps on B 4 (limit "
                      f"{TRAIN_RTOL}), parameters within {pw:.2e} (limit "
                      f"{1e-3 * TRAIN_LR:.0e})")
    # full width, bf16
    cfg = get_config("whisper-base")
    if rank == 0:
        params, axes = api.init(torch.Generator(device=dev).manual_seed(0),
                                cfg, dev, with_axes=True)
    else:
        params, axes = weights.empty_params(cfg, dev), \
            weights.param_axes(cfg)
    params, _ = place_params(params, axes, dpm, "broadcast")
    opt = adamw_init(params)
    fn = steps.make_train_step(cfg, lr=TRAIN_LR, warmup=2,
                               total=MD_DP_STEPS, mesh=dpm)
    n_attn = cfg.enc_layers + 2 * cfg.dec_layers
    real_reduce, reduce_s = steps._reduce_grads, [0.0]

    def timed_reduce(*a):
        # the gradient all-reduce's seconds, between two synchronises
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_reduce(*a)
        torch.cuda.synchronize()
        reduce_s[0] = time.perf_counter() - t
        return out

    hist = []
    steps._reduce_grads = timed_reduce
    try:
        for i, b in enumerate(_md_dp_batches(cfg, dev, MD_DP_STEPS)):
            torch.cuda.synchronize()
            ops.reset_counts()
            t0 = time.perf_counter()
            params, opt, mt = fn(params, opt, b)
            loss, gnorm = float(mt["loss"]), float(mt["grad_norm"])
            ms = (time.perf_counter() - t0) * 1e3
            launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
            check(launches == {"flash_attention": n_attn,
                               "flash_attention_bwd": n_attn} and
                  not any(ops.PLAIN_CALLS.values()),
                  f"(d) rank {rank} step {i}: launches {launches}")
            hashes = collectives.gather_objects(_md_params_hash(params),
                                                "data", mesh)
            check(len(set(hashes)) == 1,
                  f"(d) step {i}: the ranks' parameters differ")
            rl, rg = ref[i]
            dl, dg = abs(loss - rl) / abs(rl), abs(gnorm - rg) / abs(rg)
            check(dl <= MD_DP_LOSS_REL and dg <= MD_DP_GNORM_REL,
                  f"(d) step {i}: loss {loss} vs one-rank {rl} ({dl:.2e}), "
                  f"grad norm {gnorm} vs {rg} ({dg:.2e})")
            hist.append((ms, reduce_s[0]))
            if rank == 0:
                _md_say(rank, f"(d) whisper-base step {i}: loss={loss:.6f} "
                              f"(one rank {rl:.6f}, rel {dl:.2e}) grad_norm="
                              f"{gnorm:.4f} (one rank {rg:.4f}, rel "
                              f"{dg:.2e}) ms={ms:.1f} all_reduce_s="
                              f"{reduce_s[0]:.3f}; parameters bit-identical "
                              f"on both ranks; launches {launches}")
    finally:
        steps._reduce_grads = real_reduce
    steady = hist[1:]
    tok_s = WHISPER_TRAIN_B * WHISPER_TRAIN_S * len(steady) / (
        sum(ms for ms, _ in steady) / 1e3)
    if rank == 0:
        _md_say(rank, f"(d) whisper-base full width, 2 ranks x B "
                      f"{WHISPER_TRAIN_B // MD_WORLD} x ({WHISPER_T} frames, "
                      f"{WHISPER_TRAIN_S} tokens): {tok_s:,.0f} decoder "
                      f"tokens/s over steps 1-{MD_DP_STEPS - 1} (both ranks "
                      f"on one card), gradient all-reduce "
                      f"{np.mean([a for _, a in steady]):.3f}s a step "
                      f"(limits: loss {MD_DP_LOSS_REL}, grad norm "
                      f"{MD_DP_GNORM_REL})")
    del params, opt


def _md_seqtp_full(rank, mesh, ref):
    """(e) internlm2-1.8b at full width under seqtp: rank 0's seeded
    weights shipped by ``place_params``, a B 1 x S 4,096 prefill split
    2 x 2,048, against rank 0's one-rank prefill of the same tokens."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.broadcast import broadcast_bytes, place_params
    from repro_torch.core.sharding import use_sharding
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import api, weights
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    dev = mesh.device
    cfg = get_config("internlm2-1.8b")
    sm = compat_make_mesh((1, MD_WORLD), ("data", "model"))
    if rank == 0:
        params, axes = api.init(torch.Generator(device=dev).manual_seed(0),
                                cfg, dev, with_axes=True)
    else:
        params, axes = weights.empty_params(cfg, dev), \
            weights.param_axes(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _ = place_params(params, axes, sm, "broadcast")
    torch.cuda.synchronize()
    ship_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (1, MD_SEQ_S), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(21),
                         dtype=torch.int32)
    shapes = []
    real = ops.flash_attention

    def recording(q, k, v, **kw):
        shapes.append((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    caches = tfm.init_caches(cfg, 1, MD_SEQ_S, dev)
    for key in attn.SEQSHARD_ROUTES:
        attn.SEQSHARD_ROUTES[key] = 0
    torch.cuda.synchronize()
    ops.reset_counts()
    with use_sharding(sm, "seqtp"), mock.patch.object(ops, "flash_attention",
                                                      recording):
        t0 = time.perf_counter()
        logits, caches = tfm.prefill(params, cfg, toks, caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    S_loc = MD_SEQ_S // MD_WORLD
    want_shape = (S_loc, S_loc * (rank + 1))
    check(launches == {"flash_attention": cfg.n_layers} and
          shapes == [want_shape] * cfg.n_layers and
          attn.SEQSHARD_ROUTES == {"halo": 0, "gather": cfg.n_layers},
          f"(e) rank {rank}: launches {launches}, flash (S, T) "
          f"{sorted(set(shapes))}, routes {attn.SEQSHARD_ROUTES}")
    _md_say(rank, f"(e) internlm2-1.8b seqtp prefill B 1 x S {MD_SEQ_S}: "
                  f"{cfg.n_layers} flash launches at S {want_shape[0]} over "
                  f"T {want_shape[1]}, wall={wall * 1e3:.1f}ms; weights "
                  f"placed in {ship_s:.2f}s ({broadcast_bytes(params):,} "
                  f"bytes, rank 0 to rank 1)")
    if rank:
        return
    one = tfm.init_caches(cfg, 1, MD_SEQ_S, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits1, one = tfm.prefill(params, cfg, toks, one)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    top = torch.topk(logits1[0, -1].float(), 2).values
    lg = float((logits.float() - logits1.float()).abs().max())
    lg_lim = MD_SEQ_REL * float(logits1.float().abs().max())
    kv = max(float((a.float() - b.float()).abs().max()) /
             float(b.float().abs().max())
             for g1, g2 in zip(caches, one) for c1, c2 in zip(g1, g2)
             for a, b in zip(c1.values(), c2.values()))
    tok, tok1 = int(logits[0, -1].argmax()), int(logits1[0, -1].argmax())
    check(tok == tok1 and lg <= lg_lim and kv <= MD_SEQ_REL,
          f"(e) greedy {tok} vs one-rank {tok1} (top-2 gap "
          f"{float(top[0] - top[1]):.3e}), logits off by {lg:.3e} (limit "
          f"{lg_lim:.3e}), cache K/V by {kv:.3e} of their largest (limit "
          f"{MD_SEQ_REL})")
    _md_say(rank, f"(e) against the one-rank prefill (wall="
                  f"{wall1 * 1e3:.1f}ms): greedy token {tok} on both (top-2 "
                  f"gap {float(top[0] - top[1]):.3e}), last logits within "
                  f"{lg:.3e} (limit {lg_lim:.3e}), cache K/V within {kv:.3e} "
                  f"of their largest (limit {MD_SEQ_REL})")
    del params, caches, one


def _md_seqtp_reduced(rank, mesh, ref):
    """(f) the fp32 reduced gemma3-4b (10 layers, window 16) under seqtp
    at B 2 x S 1,024: local layers on the halo, the global one gathered;
    through the kernels against the plain versions, and against the
    one-rank kernel run."""
    import torch
    from repro_torch.core.sharding import use_sharding
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tfm
    dev = mesh.device
    cfg, params = _reduced_two_layers("gemma3-4b")
    sm = compat_make_mesh((1, MD_WORLD), ("data", "model"))
    toks = torch.randint(0, cfg.vocab, (2, 1024), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5),
                         dtype=torch.int32)
    out = {}
    for label, plain, m in (("kernel", False, sm), ("plain", True, sm),
                            ("one", False, None)):
        for key in attn.SEQSHARD_ROUTES:
            attn.SEQSHARD_ROUTES[key] = 0
        with use_sharding(m, "seqtp"), _forced_plain(plain):
            out[label] = tfm.forward(params, cfg, tokens=toks)[0]
        routes = dict(attn.SEQSHARD_ROUTES)
        n_local = sum(k == "L" for g in cfg.groups for k in g.pattern)
        want = {"halo": n_local, "gather": cfg.n_layers - n_local} \
            if m is not None else {"halo": 0, "gather": 0}
        check(routes == want, f"(f) {label}: routes {routes}, want {want}")
    d_plain = float((out["kernel"] - out["plain"]).abs().max())
    d_one = float((out["kernel"] - out["one"]).abs().max())
    check(torch.allclose(out["kernel"], out["plain"], atol=MD_FP32_TOL,
                         rtol=MD_FP32_TOL) and
          torch.allclose(out["kernel"], out["one"], atol=MD_FP32_TOL,
                         rtol=MD_FP32_TOL),
          f"(f) rank {rank}: kernel vs plain {d_plain:.3e}, vs one rank "
          f"{d_one:.3e}")
    _md_say(rank, f"(f) fp32 reduced gemma3-4b ({cfg.n_layers} layers, window "
                  f"{cfg.window}) seqtp forward B 2 x S 1024: kernel vs plain "
                  f"max |diff| {d_plain:.3e}, vs the one-rank kernel run "
                  f"{d_one:.3e} (atol=rtol={MD_FP32_TOL})")


def phase_list(stats, launches, smi):
    csrc = "src/repro_torch/kernels/csrc/"
    source = {"paged_decode_attention": csrc + "paged_attention.cu",
              "paged_extend_attention": csrc + "paged_attention.cu",
              "flash_attention": csrc + "flash_attention.cu",
              "decode_attention": csrc + "decode_attention.cu",
              "pair_score": csrc + "pair_score.cu",
              "ssm_scan": csrc + "ssm_scan.cu",
              "ssm_scan_fused": csrc + "selective_scan.cu",
              "mla_decode_attention": csrc + "mla_decode.cu",
              "flash_attention_bwd": csrc + "flash_attention_bwd.cu"}
    replaces = {"paged_decode_attention":
                "src/repro/kernels/paged_attention.py:78",
                "paged_extend_attention":
                "src/repro/kernels/paged_attention.py:178",
                "flash_attention": "src/repro/kernels/flash_attention.py:74",
                "decode_attention":
                "src/repro/kernels/decode_attention.py:40",
                "pair_score": "src/repro/kernels/pair_score.py:41",
                "ssm_scan": "src/repro/kernels/ssm_scan.py:44",
                "ssm_scan_fused": "src/repro/kernels/ssm_scan.py:44 with "
                                  "src/repro/kernels/ops.py:98-111",
                # no TPU kernel: JAX's plain jnp einsum chain
                "mla_decode_attention":
                "src/repro/models/attention.py:621 (mla_decode, plain "
                "jnp; no TPU kernel)",
                # no TPU kernel: JAX trains through plain jnp
                "flash_attention_bwd":
                "the gradient of src/repro/kernels/flash_attention.py:74 "
                "(JAX differentiates plain jnp, src/repro/models/"
                "attention.py:286-301; no TPU kernel)"}
    kernels = [dict(name=name, route="cuda", source=source[name],
                    replaces=replaces[name], launches=launches[name],
                    **{k: stats[name][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")})
               for name in PAGED_KERNELS + DENSE_KERNELS + ("pair_score",) +
               SSM_KERNELS + ("ssm_scan_fused",) + MLA_KERNELS +
               ("flash_attention_bwd",)]
    check(all(math.isfinite(k["ms"]) for k in kernels), "bad timing")
    print(f"[kernels] {len(kernels)} ported kernels on {smi}")
    print(json.dumps({"kernels": kernels}))


if __name__ == "__main__":
    main()
