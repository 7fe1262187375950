#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --c12-readings   # one-off readings, see below
    python3 chip_smoke.py --flash-parent SRC
    python3 chip_smoke.py --wkv-parent SRC
    python3 chip_smoke.py --scan-parent SRC

Phases (any failure exits non-zero; no phase's exception is caught):

1. the card: name, device count, ``nvidia-smi`` name and power limit;
2. build all twelve CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all started together) and print ptxas' register
   / shared-memory report; build the two simulations of the paths (the
   fast profile, 30 vehicles; the large fleet, 4096 vehicles at 1 per
   metre, whose uniform and extreme placements share one dataset);
3. hold each kernel against its plain PyTorch version on the card, TF32
   off, at the paths' shapes and at larger ones: ``fuzzy_eval`` (one
   launch, Eq. 8 inside) within 1e-4 and bit-repeatable at P = 30, 4096
   (the large fleet on the mesh) and 3,090,000 (the paper's Tokyo
   fleet); ``windowed_counts`` bit-equal at the large fleet's sorted
   round-0 arrays, at 65,536 vehicles and on a clustered fleet; the windowed election's mask equal
   to ``neighbor_elect``'s wherever its flag is 0, and flagged wherever
   the rank-distance oracle flags; ``wkv6`` at the serving prefill's
   shape (B=4, T=64, H=40, N=64, bf16 r/k/v, fp32 w) and at B=1,
   T=4096, then about its time chunk (T = 64, 65, 129 and 4096; B*H 40
   and 160) with decays of exactly 0, 1e-31 and 1 - 2^-24, each within
   1e-5 of scale and bit-repeatable; ``cohort_gemm`` at every product of
   a local-SGD step (20 samples a client; 11 calls: the four weight
   gradients carry their bias gradients as row sums), for one client
   and for a cohort of 4, within 1e-5 of scale of its plain version
   (the row sums too), bit-repeatable, the cohort's last client alone
   bit-equal to its block, then each timed: device time a call (calls
   replayed from a CUDA graph) and eager time beside ``torch.matmul``
   (``torch.einsum`` where the batch sum is the R axis) and the bounds
   at the 3xTF32 rate and the fp32 peak;
4. time each kernel and its plain version with CUDA events and print its
   bound (the larger of bytes over 3.35 TB/s and operations over the
   fp32 peak of 67 TFLOP/s; for the probe, whose conv2 and fc1 run as 3
   TF32 passes on the tensor cores, those passes at 495 TFLOP/s and the
   rest at the fp32 peak, beside its all-fp32 bound; for
   ``windowed_counts`` the pairs in DSRC range, which its data needs,
   beside every pair its window visits); ``fuzzy_eval`` at P = 30, 4096
   and 3,090,000; time the whole
   windowed election against the dense kernel at 4096, 16,384 and
   65,536 vehicles; ``wkv6`` at its two shapes, with the bound of its
   chunked design's own work beside the function's;
5. the paths, each with the launch counters reset just before and read
   just after: the round-0 selection prefix on the card against the
   port's CPU plain path, then ``FLSimulation`` (fast profile, ``dcs``)
   for 3 rounds on ``cuda``; the same 3 rounds again (default cuDNN
   algorithms); round 0's training and FedAvg held against the CPU's
   (fp64: to 1e-6; fp32: a reading); the 3 rounds twice under
   deterministic algorithms, which must repeat bit for bit; 1 unfused
   round; the large fleet for 2 rounds through ``elect="auto"`` (the
   windowed election, no dense launch unless a round overflows), then
   1 round of its extreme placement, which overflows and falls back to
   the dense kernel with the masks of ``elect="gather"``; rwkv6-3b with
   2 layers at full width, the card against the port's CPU path over 8
   teacher-forced steps; then the serving path: ``python -m
   repro_torch.launch.serve`` at full width (32 layers, B=4, prompt 64,
   32 new tokens, greedy, random weights from seed 0), which must
   launch ``wkv6`` once per layer at prefill and never in decode; then
   the same CLI with one 4096-token prompt and 4 new tokens (32
   ``wkv6`` launches, each past one time chunk);
5b. the dense family, after the rwkv6 weights are freed:
   ``flash_attention`` against its plain version (fp32 to 1e-5 and bf16
   to 2^-7 of the largest |out|, bit-repeatable) at gemma-2b's serving
   prefill (B=4, S=64, 8 q heads over 1 kv head of 256), at S=8192, a
   window (S=4096, window 1024), prefix_len 64, Sq=96 / Skv=160 without
   a mask, and Dh 64 and 128 with groups of 1 and 4; timed in bf16 (the
   tensor-core kernel) at the serving shape, at S=8192 and at jamba's
   serving shape beside the fp32 CUDA-core kernel, its plain version and
   the library's ``scaled_dot_product_attention``, with its bound (bf16
   operations at 989 TFLOP/s); gemma-2b with 2 layers at full width,
   the card against the CPU; then ``python -m repro_torch.launch.serve``
   with its default arch, gemma-2b, at full width (18 layers, B=4,
   prompt 64, 32 new tokens), which must launch ``flash_attention`` once
   per layer at prefill and nothing else;
5t. LM training, after the gemma-2b weights are freed: flash
   attention's backward (``flash_attention_bwd``) against its plain
   version (the explicit formulas in fp32) on the forward kernel's o and
   lse at gemma-2b's training shape (B=2, S=1024, 8 q heads over 1 kv
   head of 256, causal) and its microbatch (B=1, what a step launches),
   minicpm-2b's (36 heads of 64), groups of 4 at 128, a window of 256
   at S=1024, paligemma's prefix-LM (S=320, prefix 256) and an unmasked
   S=1500 at 64, fp32 within 1e-5 and bf16 within 2^-7 of each
   gradient's largest magnitude, bit-repeatable, with the forward's lse
   within 1e-5 of the plain lse and its output with lse bit-equal to
   its output without; timed in bf16 at gemma's training shape and
   microbatch and minicpm's beside its plain version, the fp32 kernels
   and ``scaled_dot_product_attention``'s backward (alone, from a
   retained forward), with its bound (10 Dh operations per
   kept pair and q head at the bf16 peak, or the bytes of q, k, v, o,
   dO and lse read and dq, dk, dv written) and the design's own count;
   then the recurrences' backwards, ``wkv6_bwd`` and
   ``selective_scan_bwd``, against their plain versions (explicit
   reverse sweeps in fp32) on the forward kernels' saved states:
   ``wkv6_bwd`` at rwkv6-3b's training microbatch (B=1, T=1024, H=40),
   at B=2, at T = 64, 65, 128 and 129 and at B=3, T=200, H=4 (a ragged
   last chunk), decays of exactly 0, 1e-31 and 1 - 2^-24 and a nonzero
   s0, its device time split by phase (A: the rows and the columns
   kernels, B: the carry, C: the carry terms and du);
   ``selective_scan_bwd`` at jamba's training
   microbatch (B=1, T=1024, Di=8192, N=16), at an odd Di and T with N=7,
   at N=32 and at Di=8200 with exp(dt a) underflowing, its device time
   split by phase (A: each chunk's forward walk, B: the carry, C: each
   chunk's sweeps, sum: the ordered sums); each in fp32
   within 1e-5 and bf16 within 2^-7 of each gradient's largest
   magnitude, the final state's cotangent given and None,
   bit-repeatable; both timed in bf16 at the microbatch beside their
   plain versions, autograd through the plain forwards, the bound and
   the design's own count (no library call computes either); one train
   step of gemma-2b, rwkv6-3b, jamba-v0.1-52b (mamba + MoE, then
   attention + MLP, 4 experts of full width; fp32, ROADMAP C3) and
   whisper-medium (2 + 2 layers over 1500 frames) with 2 layers at full
   width (B=2, S=128 over two chunks of each recurrence's backward,
   gemma-2b's S=64; 2 microbatches) on the card against the CPU (loss,
   ce, grad_norm and every parameter's update within 2^-5), each with
   its launches (the forward kernels twice a layer a microbatch, the
   backwards once); then ``python -m repro_torch.launch.train --steps 4
   --batch 2 --grad-accum 2`` at full width and depth in a child process
   for gemma-2b (``--seq 1024``: 72 ``flash_attention`` and 36
   ``flash_attention_bwd`` launches a step), rwkv6-3b (``--seq 1024``:
   128 ``wkv6`` and 64 ``wkv6_bwd``) and whisper-medium (``--seq 448``,
   its decoder's context: 288 ``flash_attention`` and 144
   ``flash_attention_bwd``): a finite loss every step, those launches a
   step and no other kernel, each step's seconds and the peak device
   memory printed;
5c. the hybrid family, after the gemma-2b weights are freed:
   ``selective_scan`` against its plain version (fp32 and bf16 inputs,
   y and hT to 1e-5 of their largest magnitude, bit-repeatable) at
   jamba's serving prefill (B=4, T=64, Di=8192, N=16), at B=1, T=4096,
   at an odd Di and T with N=7, at N=32 and T=4096 and at a Di that is
   no multiple of a block's 16 channels; timed in bf16 at the first two
   beside its
   plain version, with its bound (bytes, fp32 operations, or the exp
   count over the SFU's 16 per SM per clock); jamba-v0.1-52b with 2
   layers at full width (mamba + MoE, then attention + MLP; 4 experts
   of full width), the card against the CPU, a batch row held until a
   router near-tie sends one of its tokens to other experts on one
   side; then ``launch/serve.py``'s ``serve()`` on jamba-v0.1-52b at
   full width with 2 of its 4 layer groups (16 layers, 52 GB of bf16
   weights: 32 layers do not fit one 80 GB card; B=4, prompt 64, 32
   new tokens), which must launch ``selective_scan`` once per mamba
   layer (14) and ``flash_attention`` once per attention layer (2) at
   prefill and nothing else; then ``serve()`` again with one 4096-token
   prompt and 4 new tokens (the same launches);
5i. the rest of the LM zoo, after the jamba weights are freed (it runs
   between 5c and 5d): ``flash_attention`` against its plain version
   (fp32 to 1e-5, bf16 to 2^-7 of the largest |out|, bit-repeatable) at
   the shapes its models give it: whisper-medium's encoder (B=4, 1500
   frames, unmasked, 16 heads of 64), its cross-attention at prefill (64
   queries over 1500) and at a decode step (one query over 1500),
   paligemma-3b's prefix-LM prefill (256 patch positions + 64 tokens,
   prefix_len 256, 8 q heads over 1 kv head of 256), groups of 8 at
   head dim 128 (qwen3-moe, yi-6b) and 36 heads of 64 (minicpm-2b);
   timed in bf16 at whisper's encoder and paligemma's prefill beside
   the fp32 kernel, the plain version and ``scaled_dot_product_attention``
   with the same mask, with their bounds; whisper-medium (2 encoder and
   2 decoder layers over 1500 frames), paligemma-3b, minicpm-2b and
   qwen3-moe (16 of its experts at full width, top-2, 4 rows) with 2
   layers at full width, the card against the CPU (whisper's encoder
   K/V in the comparison); then yi-6b (32 layers), granite-8b (36),
   minicpm-2b (40), paligemma-3b (18), whisper-medium (24 + 24),
   qwen3-moe-30b-a3b (48, all 128 experts) and phi3.5-moe-42b-a6.6b (24
   of its 32 layers: 32 do not fit one 80 GB card) served at full width
   through ``launch/serve.py`` (B=4, prompt 64, 32 new tokens), each
   arch's weights freed before the next is drawn: one ``flash_attention``
   launch per attention layer at prefill (whisper's 72: encoder,
   self- and cross-attention) and none in decode but whisper's 24 a
   step (its cross-attention), no other kernel; each run's JSON line
   and the phase's wall seconds;
5d. the client mesh (``--mesh clients=K``) with ``probe_loss``:
   ``probe_loss`` against its plain version (within 1e-5 of the largest
   loss, bit-repeatable) at the fast profile's whole pack, at ranks 1
   and 3's regions of the large fleet's 4-way pack and at an odd S and
   N; its LF bit-equal to ``probe_fuzzy``'s on the same pack, and each
   region's LF bit-equal to the whole pack's (the same rows at another
   offset); timed at the region and the whole pack beside its plain
   version, with its bound; ``selection_prefix_sharded`` through a
   one-rank NCCL group, bit-equal to the single-device prefix
   (``probe_loss`` and ``fuzzy_eval`` launch once, ``probe_fuzzy``
   never); ``python -m repro_torch.launch.fl_sim --scheme dcs --rounds 2
   --mesh clients=2``: 2 ranks on the card over gloo,
   each launching ``neighbor_elect`` (the gather seam), round 0's row
   bit-equal to the single-device run's; beside it ``[mesh multihost]``,
   the same CLI with ``--multihost 2`` (2 launcher processes, one world
   over gloo): its banner names gloo and 2 processes, its rows are the
   single-host CLI's bit for bit and its 2 rank lines their launches;
   2 spawned ranks for round 0,
   whose masks equal the single-device round's and whose training half
   and FedAvg land within 1e-6 of it in fp64 under deterministic
   algorithms (fp32: a reading, as phase 5's); then the large
   fleet on 4 ranks of the card for 1 round through ``elect="auto"``
   (the ring halo): each rank launches ``probe_loss``, ``fuzzy_eval``
   and ``windowed_counts`` once and ``probe_fuzzy`` never, and the
   masks and evals equal phase 5's single-device round 0; on the same
   ranks ``[protocols]``, the paper's three selection protocols
   (``core/protocol.py``) over round 0's fleet sorted along the road,
   a block of 1024 vehicles a rank: the fuzzy gather equal to a stable
   top-n on one device, the state gather (state_dim 25) to one device's
   ``fuzzy_eval`` kernel and top-n, the DCS exchange to the dense
   ``neighbor_elect`` kernel at the window the block edges need and to
   a one-process emulation of the reference's exchange at window 64,
   each rank's collective bytes equal to N x 25 x 4, N x 4 and 6 W x 4;
   each rank's
   ``probe_loss`` time, the round's wall time and the host-staged
   collective bytes are printed (readings: four ranks share one card);
   ``[mesh event]``: on the same 4 ranks the large fleet's event server
   at churn 0.2 for 2 rounds (the sharded pool: one all-reduced partial
   (num, den) per landing tick), and the fast profile on 2 ranks with
   5g's event server (churn 0.2, weighted lambda 0.5, a 1.5-period
   cadence) for 3 rounds, each against the same rounds on one device:
   rows' integer and async columns, masks and accuracy (1e-5) equal,
   the params gap per round a reading; ``[mesh resume]``: that 2-rank
   run killed by SIGKILL on rank 0 at round 0's snapshot (whose pool
   holds pending ``num`` / ``den`` entries) and resumed by 2 fresh
   ranks: rows and the params' sha256 equal the uninterrupted run's;
5e. the paper's profile (``paper_config("dcs")``: Table 3's 30 local
   epochs, a 20 s deadline, 12 clients of 4500 samples and 18 of 45),
   round 0 through ``drive_rounds`` at the full 30 epochs (the Eq. 6
   deadline drops every 4500-sample client, so only the 60-cap cohort
   trains: 90 local-SGD steps): ``probe_fuzzy`` and ``neighbor_elect``
   launch once each and nothing else, the prefix's masks equal the
   port's CPU plain path on the same fields (evals within 1e-3, a
   mismatch only at a near-tie, C3), the row carries the reference's
   14 keys in order and its comm columns equal ``core/overhead.py``
   computed here (==); prefix s, round s, steps per group and ms per
   local-SGD step (the training half timed alone) are printed; then the
   fast profile's round 0 under deterministic algorithms: the loop
   engine against the batched one (masks, counts and comm columns
   equal; fp32 accuracy and params within 1e-5, ROADMAP C8, rounds 1-2
   after it a reading; fp64 training halves within 1e-6) and FedProx
   (mu 0.01), the card against the CPU in fp64 within 1e-6; C8 op by
   op: one local-SGD step alone and in the cohort of four, every op and
   gradient bit-equal through ``cohort_gemm``, beside one batched
   ``torch.matmul`` over the cohort (cuBLAS, the port's form before C12)
   and cuDNN's grouped convolution (readings), with each form's step
   device time and the kernels the profiler sees in each; ``[c12]``: 3
   fast rounds of the loop and
   the batched engine on the same draws, default algorithms, held to
   the reference's engine contract (masks, counts equal, accuracy
   within 1e-5); a trained paper round under the profiler: the card's
   busy share of its wall, its kernels and host ops by time; then
   ``python -m
   repro_torch.launch.fl_sim --scheme all --rounds 1 --out`` and
   ``--paper-profile --scheme dcs --rounds 1 --out``: rc 0, every scheme's rows with the reference's keys in
   order, the paper CLI's launch line ``probe_fuzzy`` 1 and
   ``neighbor_elect`` 1, its comm columns == ``core/overhead.py``, no
   temporary file left;
5f. the multi-seed sweep (``launch/sweep.py``): for one ``dcs`` group
   of 4 fast-cell seeds, the seed-batched ``probe_fuzzy`` and
   ``neighbor_elect`` (one launch for the 4 seeds) bit-equal to 4 single
   launches, within 1e-5 of scale of their plain seed versions,
   bit-repeatable, Eq. 8 per seed (one seed's aux times 1024 moves no
   bit of any seed), and the seed-batched prefix bit-equal to 4
   single-seed prefixes; both kernels and the prefix timed against the
   4 single forms; then ``python -m repro_torch.launch.sweep --fast
   --seeds 4 --rounds 2 --schemes all`` through its ``main`` twice and
   with ``--no-vmap`` (the CSVs byte-equal; one ``probe_fuzzy`` a round
   a group and one ``neighbor_elect`` a round of the ``dcs`` group; 4
   of each with ``--no-vmap``), ``--paper-profile --seeds 1 --rounds
   1`` (Table 3's comm columns) and ``--paper-profile --seeds 2``, which
   raises the reference's partition error (ROADMAP C10); ``probe_loss``
   with the seed axis (4 seeds at the fast packs and at the large
   fleet's 4-way regions, S = 48,612, N = 4096) and ``fuzzy_eval`` (4
   seeds at P = 30 and 4096, each seed's own Eq. 8 maxima and external
   ones), one launch each, bit-equal to 4 single launches, within
   tolerance of the plain versions, bit-repeatable, timed against 4
   single launches beside 4 x the bound; ``[mesh sweep]``: ``python -m
   repro_torch.launch.sweep --fast --seeds 4 --rounds 2 --schemes all
   --mesh clients=2`` against the single-device CSV (integer columns
   equal, accuracy within 1e-5), each rank launching ``probe_loss`` and
   ``fuzzy_eval`` once a round a group;
5g. the round drivers (``rounds.run_schedule``, round-ahead by
   default, and ``fl/async_server.py``): the fast profile ``dcs`` for 4
   rounds, round-ahead and serially in alternation (4 runs, rows and
   params bit-equal; the first round-ahead run under
   ``torch.cuda.set_sync_debug_mode("error")`` from each round's
   training dispatch through the next prefix's enqueue, the second
   counting synchronising calls by site), the median round of rounds
   1-3 of each schedule a reading; the large fleet 2 rounds each way
   (masks and rows equal, the synchronising calls left on its stretch
   by site); the degenerate event server bit-equal to the sync driver;
   churn 0.2 + weighted staleness lambda 0.5 + a cadence of 1.5 periods
   for 4 rounds, the card against the CPU in lockstep (masks under C3's
   near-tie rule, ``n_active``, landing ticks unless ``t_done / T`` is
   within 1e-5 of an integer, counts, histograms and stale fraction
   equal, ``n_effective`` within 1e-9, accuracy within 0.01, one
   ``probe_fuzzy`` and one ``neighbor_elect`` launch a round, some round
   stale); ``neighbor_elect`` (N = 30) and ``windowed_counts`` (the large
   fleet's round 0 at churn 0.2) on churn-gated evals bit-equal to their
   plain versions; ``python -m repro_torch.launch.fl_sim --scheme all
   --rounds 3 --server event --churn-rate 0.2 --staleness weighted
   --staleness-lambda 0.5 --out``; the sweep over churn {0, 0.2} x
   lambda {0, 0.5} by default, with ``--no-vmap``, with
   ``--no-overlap-rounds`` and again (CSVs byte-equal; one
   ``probe_fuzzy`` and one ``neighbor_elect`` a round a group for both
   seeds, one a seed with ``--no-vmap``);
5h. preemption (``train/checkpoint.py``, ``launch/faults.py``, the
   drivers' ``capture_state`` / ``restore_state``): C4 first, the fast
   profile's 4 rounds and the paper profile's 2 under the default and
   the deterministic algorithms in turns (each mode's median trained
   round; each must repeat bit for bit); snapshot bytes and capture +
   write + fsync seconds (fast profile, the sweep's 4-seed group, the
   large fleet, the event server with its pool), the fast round with a
   snapshot every round and without, the sweep's wall time with its
   default and a fresh checkpoint directory (readings); a card snapshot
   restored on the CPU and a CPU one on the card (params bit-equal);
   then child processes started with ``REPRO_FAULTS``, all at once,
   each of which must die by SIGKILL: the fast profile ``dcs`` at round
   1's snapshot round-ahead and serially, the large fleet at round 0's,
   the event server (churn 0.2, weighted lambda 0.5, a 1.5-period
   cadence) at round 1's with a non-empty pending pool, ``python -m
   repro_torch.launch.sweep --fast --seeds 4 --rounds 2 --schemes
   dcs,random`` at ``group-done:index=0`` and at its first snapshot;
   then the resumes, each a fresh child, all at once: rows, masks and a
   params sha256 equal to the uninterrupted run's (made in this
   process), the large fleet again under ``overflow@resume`` (one
   ``neighbor_elect`` launch on its dense re-run), a copy of the
   round-ahead snapshots with the newest ``arrays.npz`` torn by
   ``faults flipbyte`` (a warning, a fall back to round 0, the same
   rows), the sweeps' CSVs byte-equal, the skip line where a group had
   finished, one ``probe_fuzzy`` a round a group left to run;
6. the probe's time split by phase (conv, fc1, fc2 + NLL, the client
   sums) with ``torch.profiler`` at the fast profile's and the large
   fleet's packs, last, since launches cost more in a process once the
   profiler has run; ``wkv6``'s device time per launch by phase (A, B,
   C) and ``selective_scan``'s at their two shapes, beside their
   CUDA-event times; the device time per launch of ``fuzzy_eval`` (P =
   30 and 4096), ``neighbor_elect`` (N = 30) and ``windowed_counts`` (M
   = 4096 and 65,536) beside their bounds, their CUDA-event times and a
   one-element in-place add's, the card's launch floor; the two
   seed-batched kernels' device time a launch against 4 single
   launches; then ``{"kernels": [...]}`` on the line before the last,
   ``probe_fuzzy``'s and ``neighbor_elect``'s entries with a ``seeds``
   object (S, the fast sweep's launches, ms, the S single launches' ms,
   device ms of both, the bound scaled by S), ``probe_loss``'s and
   ``fuzzy_eval``'s with one too (the mesh sweep's rank-0 launches, no
   device ms), ``flash_attention``'s with a ``paths`` list (phase 5i's
   whisper encoder and paligemma prefill: the shape, the arch's serving
   launches, its bf16 error and times, bound and library time),
   ``flash_attention_bwd``'s (the training path's launches, gemma-2b's
   training shape; ``computes``: the vjp it replaces, its device time,
   and minicpm-2b's shape in ``paths``), ``wkv6_bwd``'s and
   ``selective_scan_bwd``'s (the rwkv6-3b path's launches and the jamba
   check's, the microbatch's shape, ``computes``, device time, autograd
   through the plain forward, the design's own bound); the line's
   ``kernels`` are the eight that port a Pallas kernel and the
   backwards of ``flash_attention``, ``wkv6`` and ``selective_scan``,
   and its
   ``other_kernels`` hold ``cohort_gemm`` (the local-SGD products, which
   the reference leaves to XLA: its headline conv2's input gradient in
   the cohort of 4, device time beside ``torch.matmul``, with the same
   keys but ``reference`` in place of ``replaces``, and ``products``:
   every product of the step at C = 1 and 4, its device and eager time,
   the library call's, the plain version's and both bounds);
7. ``{"ok": true, "device": {...}}`` as the last line.

``--c12-readings`` takes two one-off readings instead (no result line):
``[c12]`` through the plain products (cuBLAS), and the trained rounds'
wall time (fast and paper profile), which uses only entry points older
than ``cohort_gemm``, so this file run from an older checkout's root
times that checkout.  ``--gemm-readings [SRC]`` times the cohort GEMM
through the package under SRC (default this checkout's ``src``; an
older checkout's ``src`` times its kernel with this file's harness):
every product of a step for one client and a cohort of 4, the trained
rounds, then ``[c8]``'s step device time through the kernel and
through cuBLAS (no result line).  ``--flash-parent SRC`` builds the
``flash_attention.cu`` and ``flash_attention_bwd.cu`` of the package
under SRC (an older checkout's ``src``), holds this tree's forward,
without and with its lse output, bit-equal to it at every
flash_attention shape of this file, and times both backwards in turns
beside SDPA's at gemma-2b's training shape and microbatch and
minicpm-2b's, each within tolerance of the plain version (no result
line).  ``--wkv-parent SRC`` builds the ``wkv6_bwd.cu`` of the package
under SRC with the same helper and times it against this tree's in
turns in bf16 at rwkv6-3b's training microbatch (B=1, T=1024, H=40),
both within 2^-7 of each gradient's largest magnitude of the plain
version (bits not compared: the order of the sums differs), then this
tree's device time by phase (no result line).  ``--scan-parent SRC``
does the same for ``selective_scan_bwd.cu`` at jamba's training
microbatch (B=1, T=1024, Di=8192, N=16).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# cuBLAS needs a fixed workspace before its first call for phase 5's
# deterministic replay (torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12            # non-tensor-core fp32 peak
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak
TF32_FLOP_PER_S = 495e12           # dense TF32 tensor-core peak

# CNN work per probe sample (multiply-adds x 2): conv2 and fc1, which the
# kernel runs on the tensor cores as 3 TF32 passes, and conv1 and fc2,
# which it runs in fp32 on CUDA cores
PROBE_TC_FLOP = 2 * (14 * 14 * 64 * 32 * 25 + 3136 * 512)
PROBE_CC_FLOP = 2 * (28 * 28 * 32 * 25 + 512 * 10)
PROBE_FLOP_PER_SAMPLE = PROBE_TC_FLOP + PROBE_CC_FLOP
# the probe's phases by kernel name (phase 4: the client sums)
PROBE_PHASES = (("split", ("split_weights_kernel",)),
                ("conv", ("probe_conv_kernel",)),
                ("fc1", ("fc1_kernel",)),
                ("fc2 + NLL", ("fc2_nll_kernel",)),
                ("client sums", ("client_span_kernel", "client_sum_kernel",
                                 "Memset")),
                ("finish", ("finish_kernel", "client_mean_kernel")))
# wkv6's phases and selective_scan by kernel name
WKV_PHASES = (("A", ("wkv6_chunk_kernel",)), ("B", ("wkv6_carry_kernel",)),
              ("C", ("wkv6_cross_kernel",)))
SCAN_PHASES = (("scan", ("selective_scan_kernel",)),)
# Mamdani per participant: 12 memberships x 5 ops, 81 rules x (3 min +
# 1 max), the COG's 9 x 3 ops + 1 division; Eq. 8 adds 4 maxima, 4
# multiplies and 8 clip ops
MAMDANI_OPS = 12 * 5 + 81 * 4 + 9 * 3 + 1
EQ8_OPS = 16
ELECT_OPS_PER_PAIR = 8             # sub, abs, 4 compares, and/or, add
LARGE_FLEET = 4096                 # vehicles of the large-fleet path
# fuzzy_eval's bulk case: the paper's Tokyo fleet
# (src/repro/kernels/fuzzy_eval.py:5-6), (P, 4) fp32, ~50 MB
TOKYO_FLEET = 3_090_000
# the serving path: rwkv6-3b at full width, 4 prompts of 64 tokens, 32
# new tokens each; its WKV shape
SERVE_ARGV = ["--arch", "rwkv6-3b", "--batch", "4", "--prompt-len", "64",
              "--max-new", "32"]
WKV_B, WKV_T, WKV_H, WKV_N = 4, 64, 40, 64
# wkv6's edge cases beside those two shapes, (B, T, H): T about the
# kernel's time chunk (C = 64: one chunk, C + 1, 2C + 1) and a long
# prompt, B * H 40 and 160, decays with exact zeros, values under 1e-30
# and 1 - 2^-24 (``wkv_inputs(edge=True)``), a nonzero s0
WKV_EDGE = [(1, 64, 40), (1, 65, 40), (1, 129, 40), (4, 129, 40),
            (1, 4096, 40), (4, 4096, 40)]
# the long-prompt serving paths: one 4096-token prompt, 4 new tokens
LONG_PROMPT = 4096
LONG_SERVE_ARGV = ["--arch", "rwkv6-3b", "--batch", "1", "--prompt-len",
                   str(LONG_PROMPT), "--max-new", "4"]
# bf16 tolerance of the model check, relative to each tensor's largest
# magnitude: the card and the CPU round bf16 at other places (cuBLAS
# against oneDNN, FMA), a few bf16 ulps (2^-8) through the blocks
MODEL_TOL = 2 ** -5
# the dense serving path: gemma-2b (the CLI's default --arch) at full
# width, 4 prompts of 64 tokens, 32 new tokens each
GEMMA_SERVE_ARGV = ["--batch", "4", "--prompt-len", "64", "--max-new", "32"]
# flash_attention's shapes: (B, Sq, Skv, Hq, Hkv, Dh, causal, window,
# prefix_len); the first is gemma-2b's serving prefill (8 q heads over 1
# kv head of 256), the second a long prompt, the last jamba-v0.1-52b's
# serving prefill (32 q heads over 8 kv heads of 128)
JAMBA_FLASH = (4, 64, 64, 32, 8, 128, True, 0, 0)
FLASH_CASES = [
    (4, 64, 64, 8, 1, 256, True, 0, 0),
    (1, 8192, 8192, 8, 1, 256, True, 0, 0),
    (1, 4096, 4096, 8, 1, 256, True, 1024, 0),    # sliding window
    (2, 300, 300, 8, 1, 256, True, 0, 64),        # prefix-LM
    (2, 96, 160, 8, 1, 256, False, 0, 0),         # Sq != Skv, not causal
    (2, 200, 200, 4, 4, 64, True, 0, 0),          # Dh 64, groups of 1
    (2, 200, 200, 8, 2, 64, True, 0, 0),          # Dh 64, groups of 4
    (2, 200, 200, 4, 4, 128, True, 0, 0),         # Dh 128, groups of 1
    (2, 200, 200, 8, 2, 128, True, 0, 0),         # Dh 128, groups of 4
    JAMBA_FLASH,
]
# the hybrid serving path: jamba-v0.1-52b at full width with 2 of its 4
# layer groups (16 layers), 4 prompts of 64 tokens, 32 new tokens each;
# its 2-layer check puts the MoE on the mamba layer, with 4 experts
JAMBA = "jamba-v0.1-52b"
JAMBA_GROUPS = 2
JAMBA_SERVE = dict(batch=4, prompt_len=64, max_new=32, temperature=0.0,
                   seed=0)
JAMBA_CHECK = dict(num_layers=2, attn_layer_period=2, attn_layer_offset=1,
                   moe_layer_offset=0, num_experts=4)
JAMBA_LONG_SERVE = dict(JAMBA_SERVE, batch=1, prompt_len=LONG_PROMPT,
                        max_new=4)
# selective_scan's shapes: (B, T, Di, N); the first is jamba's serving
# prefill (Di = 2 x 4096), the second a long prompt, the third an odd Di
# and T with N under 8 (padded), then N = 32 (4 states a lane) at the
# long prompt and a Di that is no multiple of a block's 16 channels
SCAN_CASES = [(4, 64, 8192, 16), (1, 4096, 8192, 16), (3, 77, 300, 7),
              (1, 4096, 8192, 32), (2, 100, 8200, 16)]
# phase 5i, the rest of the LM zoo: flash_attention at the shapes its
# models give it: whisper-medium's encoder (1500 frames, unmasked, 16
# heads of 64 without grouping), its cross-attention at prefill (64
# decoder positions over 1500) and at a decode step (one query),
# paligemma-3b's prefix-LM prefill (256 patch positions + 64 tokens, 8 q
# heads over 1 kv head of 256), qwen3-moe's and yi-6b's groups of 8 at
# 128, minicpm-2b's 36 heads of 64
WHISPER_ENC_FLASH = (4, 1500, 1500, 16, 16, 64, False, 0, 0)
PALIGEMMA_FLASH = (4, 320, 320, 8, 1, 256, True, 0, 256)
ZOO_FLASH_CASES = [WHISPER_ENC_FLASH,
                   (4, 64, 1500, 16, 16, 64, False, 0, 0),
                   (4, 1, 1500, 16, 16, 64, False, 0, 0),
                   PALIGEMMA_FLASH,
                   (4, 64, 64, 32, 4, 128, True, 0, 0),
                   (4, 64, 64, 36, 36, 64, True, 0, 0)]
# its 2-layer model checks at full width: arch -> (cache keys compared
# within MODEL_TOL, config changes, batch rows).  whisper's with 2
# encoder layers over its 1500 frames; qwen3-moe's with 16 of its 128
# experts (full width), top-2, over 4 rows (with 128 experts top-8 a
# bf16 router near-tie reroutes some token of every row, ROADMAP C3),
# and a capacity that drops no token: a drop couples the rows (a
# rerouted token moves the expert positions of the batch's later
# tokens), so a reroute would move other rows too
ZOO_CHECKS = {
    "whisper-medium": (("k", "v", "cross_k", "cross_v"),
                       dict(num_layers=2, encoder_layers=2), 2),
    "paligemma-3b": (("k", "v"), None, 2),
    "minicpm-2b": (("k", "v"), None, 2),
    "qwen3-moe-30b-a3b": (("k", "v"), dict(num_layers=2, num_experts=16,
                                           experts_per_token=2,
                                           capacity_factor=8.0), 4),
}
# its serving runs, 4 prompts of 64 tokens, 32 new tokens each, every
# arch at full depth but phi3.5-moe, whose 32 layers (~84 GB in bf16) do
# not fit one 80 GB card: 24 of them leave room for one layer drawn in
# fp32 (~5.2 GB)
ZOO_ARCHS = ("yi-6b", "granite-8b", "minicpm-2b", "paligemma-3b",
             "whisper-medium", "qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b")
ZOO_SERVE_ARGV = ["--batch", "4", "--prompt-len", "64", "--max-new", "32"]
PHI = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 24
# the keys of the reference's rows, in its order
# (``repro.fl.rounds.FLSimulation._round_row``)
ROW_KEYS = ["round", "accuracy", "n_selected", "n_aggregated",
            "n_straggler", "n_active", "stale_frac", "n_effective",
            "rounds_behind_hist", "mean_eval_selected", "state_bytes",
            "upload_bytes", "state_time_s", "comm_time_s"]
# the §4.2 accumulated-time model of each scheme (core/overhead.py keys)
OVERHEAD_KEYS = {"dcs": "dcs", "ccs-fuzzy": "ccs-fuzzy", "random": "cfl"}
# FedProx's mu in phase 5e's check
PROX_MU = 0.01
# exp (one MUFU.EX2 each) per second: 16 per SM per clock, 132 SMs at
# the H100 SXM's 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9


def prefix_launches(counts: dict) -> dict:
    """A run's kernel launches without ``cohort_gemm``'s, whose count
    follows the cohorts' local-SGD steps (phase 5 and ``[c12]`` read
    it)."""
    return {k: v for k, v in counts.items() if k != "cohort_gemm"}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, n_ops: float, flop_per_s: float = FP32_FLOP_PER_S):
    """(least ms, what bounds it) for the work of one call, its
    operations at ``flop_per_s`` (the peak for the inputs' type)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flop_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ptxas_function(line: str):
    """The kernel a ``ptxas info : Compiling entry function`` line names:
    its name, with its template arguments as mangled; else None."""
    m = re.search(r"entry function '_Z(\d+)(\w+)'", line)
    if not m:
        return None
    n, rest = int(m.group(1)), m.group(2)
    name, rest = rest[:n], rest[n:]
    if rest.startswith("I") and "E" in rest:
        name += f"<{rest[1:rest.index('E')]}>"
    return name


def visited_pairs(m: int, block: int, window: int) -> int:
    """Row-candidate pairs that ``windowed_counts`` compares on (M,)
    arrays: row block ib sweeps blocks [ib - hops, ib + hops] clipped
    to the array, hops = ceil(window / block)."""
    nb, hops = m // block, -(-window // block)
    return sum(min(ib + hops, nb - 1) - max(ib - hops, 0) + 1
               for ib in range(nb)) * block * block


def in_range_pairs(sp, block: int, window: int, comm_range: float) -> int:
    """Those of ``visited_pairs`` whose positions lie within
    ``comm_range`` on the sorted (M,) positions ``sp``: the pair tests
    this run's data needs, since a pair out of range never counts (the
    kernel skips sub-chunks wholly out of range)."""
    import torch
    m = sp.shape[0]
    nb, hops = m // block, -(-window // block)
    ib = torch.arange(m, device=sp.device) // block
    c0 = (ib - hops).clamp(min=0) * block
    c1 = ((ib + hops).clamp(max=nb - 1) + 1) * block
    lo = torch.searchsorted(sp, sp - comm_range)
    hi = torch.searchsorted(sp, sp + comm_range, right=True)
    return int((torch.minimum(hi, c1) - torch.maximum(lo, c0))
               .clamp(min=0).sum())


def wkv_inputs(b, t, h, g, device, edge=False):
    """Model-like WKV operands: unit-scale bf16 r, k, v, fp32 decays
    over (0.37, 0.9975) (``exp(-exp(w0 + lora))`` with w0 = -6 gives
    0.9975), bonus u ~ 0.5 N(0, 1), a nonzero fp32 initial state.
    ``edge``: every 7th decay exactly 0, every 11th 1e-31, every 13th
    1 - 2^-24 (the largest fp32 below 1)."""
    import torch
    r, k, v = (torch.randn(b, t, h, WKV_N, generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))
    w = torch.exp(-torch.exp(torch.rand(b, t, h, WKV_N, generator=g,
                                        device=device) * 6 - 6))
    if edge:
        flat = w.view(-1)
        flat[::7], flat[3::11], flat[5::13] = 0.0, 1e-31, 1 - 2 ** -24
    u = 0.5 * torch.randn(h, WKV_N, generator=g, device=device)
    s0 = torch.randn(b, h, WKV_N, WKV_N, generator=g, device=device)
    return r, k, v, w, u, s0


def wkv_bound(b, t, h):
    """(ms, by) for one WKV call: bf16 r, k, v, fp32 w read and fp32 y
    written per (b, t, h, n); u, s0 read and sT written once; ~6 N^2
    fp32 operations per (b, h, t)."""
    n_bytes = (b * t * h * WKV_N * (3 * 2 + 4 + 4) + h * WKV_N * 4
               + 2 * b * h * WKV_N * WKV_N * 4)
    return bound(n_bytes, 6 * WKV_N * WKV_N * b * h * t)


def wkv_design_bound(b, t, h):
    """(ms, by) for the work ``csrc/wkv6.cu``'s design does: phase A ~5
    N^2 fp32 operations per (b, h, t) (the bonus term out of the inner
    loop); past one chunk, phase C's 2 N^2 per (b, h, t) after the first
    chunk and phase B's 2 N^2 per chunk, and beside the function's
    bytes, phase C's second read of r and w and its read and write of y,
    and the chunks' end states (written by A, read and written by B,
    read by C) and decay products."""
    from repro_torch.kernels.wkv6 import CHUNK
    n_bytes = (b * t * h * WKV_N * (3 * 2 + 4 + 4) + h * WKV_N * 4
               + 2 * b * h * WKV_N * WKV_N * 4)
    n_ops = 5 * WKV_N * WKV_N * b * h * t
    chunks = -(-t // CHUNK)
    if chunks > 1:
        later = b * h * (t - CHUNK)
        n_ops += 2 * WKV_N * WKV_N * (later + b * h * (chunks - 1))
        n_bytes += (later * WKV_N * (2 + 4 + 8)
                    + b * h * chunks * (4 * WKV_N * WKV_N + 2 * WKV_N) * 4)
    return bound(n_bytes, n_ops)


def tree_to(tree, device):
    """A parameter or cache tree (dicts, lists, tensors) on ``device``."""
    import torch
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return [tree_to(v, device) for v in tree]


def scaled_err(got, want) -> float:
    """Max abs error over the largest magnitude of ``want``."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(
        min=1e-30))


def large_fleet_config(distribution: str):
    """The large-fleet path: the fast profile's client shapes (12 big
    clients of 300 samples, the rest of 45) for 4096 vehicles on a
    4096 m road, the density of the reference's ``windowed_scaling``
    bench; 23000 samples per class is the smallest round figure that
    partitions 4096 clients without exhausting a class."""
    from repro_torch.fl.mobility import MobilityConfig
    from repro_torch.launch.fl_sim import fast_config
    cfg = fast_config("dcs", n_rounds=2, samples_per_class=23000)
    cfg.partition = dataclasses.replace(cfg.partition,
                                        n_clients=LARGE_FLEET)
    cfg.mobility = MobilityConfig(n_vehicles=LARGE_FLEET,
                                  road_length_m=float(LARGE_FLEET),
                                  distribution=distribution, seed=0)
    return cfg


@contextlib.contextmanager
def one_dataset():
    """While inside, ``FLSimulation`` builds each synthetic dataset once:
    simulations of one data configuration share it."""
    from repro_torch.fl import rounds
    make = rounds.make_dataset
    rounds.make_dataset = functools.lru_cache(maxsize=1)(make)
    try:
        yield
    finally:
        rounds.make_dataset = make


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device ms a call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so that the
    host's cost of a launch (Python, ctypes, allocation) is out of the
    reading."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * calls)


def kept_pairs(sq, skv, causal, window, prefix) -> int:
    """(q, kv) pairs that flash_attention's mask keeps, per batch row and
    q head."""
    import torch
    qp, kp = torch.arange(sq)[:, None], torch.arange(skv)[None, :]
    if not causal:
        return sq * skv
    ok = kp <= qp
    if window:
        ok &= (qp - kp) < window
    if prefix:
        ok |= kp < prefix
    return int(ok.sum())


def flash_bound(case, elem_bytes: int):
    """(ms, by) for one flash_attention call: q, k, v read and o written
    once; 4 Dh operations per kept pair and q head, at the bf16
    tensor-core peak for bf16 inputs, the fp32 peak for fp32 ones."""
    b, sq, skv, hq, hkv, dh, causal, window, prefix = case
    n_bytes = (2 * b * sq * hq + 2 * b * skv * hkv) * dh * elem_bytes
    n_ops = 4 * dh * kept_pairs(sq, skv, causal, window, prefix) * b * hq
    return bound(n_bytes, n_ops,
                 BF16_FLOP_PER_S if elem_bytes == 2 else FP32_FLOP_PER_S)


def flash_inputs(case, dtype, device, seed=0):
    import torch
    b, sq, skv, hq, hkv, dh = case[:6]
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(b, s, h, dh, generator=g, device=device).to(dtype)
            for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]


def flash_label(case, dtype) -> str:
    b, sq, skv, hq, hkv, dh, causal, window, prefix = case
    return (f"B={b} Sq={sq} Skv={skv} Hq={hq} Hkv={hkv} Dh={dh} "
            f"causal={causal} window={window} prefix={prefix} "
            f"{str(dtype).split('.')[-1]}")


def flash_checks(dev, cases=FLASH_CASES) -> dict:
    """flash_attention against its plain version at every case, fp32 and
    bf16: both compute in fp32 and round the output once, so fp32 within
    1e-5 of the largest |out| (sums in another order) and bf16 within
    2^-7 of it (one bf16 ulp at the largest value); a second launch
    equal bit for bit.  Returns the max abs error in bf16 a case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    errs = {}
    for case in cases:
        kw = dict(zip(("causal", "window", "prefix_len"), case[6:]))
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            q, k, v = flash_inputs(case, dtype, dev)
            out = flash_attention_cuda(q, k, v, **kw)
            again = flash_attention_cuda(q, k, v, **kw)
            want = ref.flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = scaled_err(out, want)
            same = torch.equal(out, again)
            ok = (err <= tol and same and out.dtype == dtype
                  and bool(torch.isfinite(out).all()))
            if dtype == torch.bfloat16:
                errs[case] = float((out.float() - want.float()).abs().max())
            log(f"[check] flash_attention {flash_label(case, dtype)}: max err "
                f"/ scale {err:.3g} (tol {tol:.3g}), bit-repeatable {same} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention {case} {dtype} "
                                     f"disagrees")
            del q, k, v, out, again, want
    return errs


def sdpa_mask(case, device) -> dict:
    """``scaled_dot_product_attention``'s keywords for ``case``'s mask:
    ``is_causal`` for a plain causal one, a boolean (Sq, Skv) mask for a
    window or a prefix, none when not causal."""
    import torch
    sq, skv, causal, window, prefix = (case[1], case[2]) + tuple(case[6:])
    if not causal:
        return {}
    if not (window or prefix):
        return {"is_causal": True}
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    ok = kp <= qp
    if window:
        ok &= (qp - kp) < window
    if prefix:
        ok |= kp < prefix
    return {"attn_mask": ok}


def flash_times(dev, cases=((FLASH_CASES[0], 200), (FLASH_CASES[1], 5),
                            (JAMBA_FLASH, 200))):
    """flash_attention (bf16: the tensor-core kernel), its plain version
    and the library's ``scaled_dot_product_attention`` (GQA, the same
    mask) in bf16 at each (case, iterations), by default gemma's serving
    shape, the long prompt and jamba's serving shape, each with its
    bound, beside the fp32 CUDA-core kernel on the same values in fp32.
    Returns (ms, plain ms, bound ms, bound by, library ms) a case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    rows = []
    for case, iters in cases:
        kw = dict(zip(("causal", "window", "prefix_len"), case[6:]))
        q, k, v = flash_inputs(case, torch.bfloat16, dev, seed=2)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = sdpa_mask(case, dev)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, enable_gqa=True,
                                                  **mask)
        lib_err = scaled_err(library().transpose(1, 2),
                             ref.flash_attention_ref(q, k, v, **kw))
        ms = time_ms(lambda: flash_attention_cuda(q, k, v, **kw), iters)
        plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw),
                           iters)
        lib_ms = time_ms(library, iters)
        qf, kf, vf = (t.float() for t in (q, k, v))
        fp32_ms = time_ms(lambda: flash_attention_cuda(qf, kf, vf, **kw),
                          iters)
        b_ms, b_by = flash_bound(case, 2)
        log(f"[time] flash_attention {flash_label(case, torch.bfloat16)}: "
            f"kernel {ms:.4f} ms (tensor cores), fp32 kernel {fp32_ms:.4f} "
            f"ms (CUDA cores, fp32 inputs), plain {plain_ms:.4f} ms, "
            f"library (scaled_dot_product_attention; max err / scale "
            f"against plain {lib_err:.3g}) {lib_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by})")
        rows.append((ms, plain_ms, b_ms, b_by, lib_ms))
        del q, k, v, qt, kt, vt, qf, kf, vf, mask
    return rows


def scan_inputs(case, dtype, device, seed=0):
    """Model-like scan operands: unit-scale x, B and C, dt a softplus of
    small values (jamba's dt_bias puts it near 0.01), negative a, a
    nonzero initial state; x, dt, B and C in ``dtype``."""
    import torch
    import torch.nn.functional as F
    b, t, di, n = case
    g = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device=device)
    x, dt = rnd(b, t, di), F.softplus(rnd(b, t, di) - 4)
    bm, cm = rnd(b, t, n), rnd(b, t, n)
    a, h0 = -torch.exp(0.5 * rnd(di, n)), 0.1 * rnd(b, di, n)
    return [z.to(dtype) for z in (x, dt, bm, cm)] + [a, h0]


def scan_label(case, dtype) -> str:
    b, t, di, n = case
    return f"B={b} T={t} Di={di} N={n} {str(dtype).split('.')[-1]}"


def scan_bound(case, elem_bytes: int):
    """(ms, by, {part: ms}) for one selective_scan call, the largest of
    three times: the bytes (x, dt, B and C read once in their type; a,
    h0 read and hT written once in fp32; y written in fp32) over the
    memory rate; 6 fp32 operations per (b, t, d, n) (dt a, da h, dtx B,
    their sum, h C, its sum) and 1 per (b, t, d) (dt x) over the fp32
    peak; one exp per (b, t, d, n) over the SFU's rate, counted as
    operations."""
    b, t, di, n = case
    n_bytes = (2 * b * t * di + 2 * b * t * n) * elem_bytes + (
        di * n + 2 * b * di * n + b * t * di) * 4
    parts = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "fp32": (6 * b * t * di * n + b * t * di)
             / FP32_FLOP_PER_S * 1e3,
             "exp": b * t * di * n / SFU_EXP_PER_S * 1e3}
    top = max(parts, key=parts.get)
    return (parts[top], "bytes" if top == "bytes" else "operations",
            parts)


def scan_checks(dev) -> float:
    """selective_scan against its plain version at every case, fp32 and
    bf16 inputs: both compute in fp32 from the same operands, so y and
    hT within 1e-5 of their largest magnitude (sums in another order,
    FMA); a second launch equal bit for bit.  Returns the max abs error
    of y at the serving shape in bf16."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    err_serve = None
    for case in SCAN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            args = scan_inputs(case, dtype, dev)
            y, h_t = selective_scan_cuda(*args)
            y2, h_t2 = selective_scan_cuda(*args)
            want_y, want_h = ref.selective_scan_ref(*args)
            torch.cuda.synchronize()
            e_y, e_h = scaled_err(y, want_y), scaled_err(h_t, want_h)
            same = torch.equal(y, y2) and torch.equal(h_t, h_t2)
            ok = (e_y <= 1e-5 and e_h <= 1e-5 and same
                  and bool(torch.isfinite(y).all()))
            if case == SCAN_CASES[0] and dtype == torch.bfloat16:
                err_serve = float((y - want_y).abs().max())
            log(f"[check] selective_scan {scan_label(case, dtype)}: y max "
                f"err / scale {e_y:.3g} (scale "
                f"{float(want_y.abs().max()):.4g}), hT {e_h:.3g} (tol "
                f"1e-5); bit-repeatable {same} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"selective_scan {case} {dtype} "
                                     f"disagrees")
            del args, y, y2, h_t, h_t2, want_y, want_h
    return err_serve


def scan_times(dev):
    """selective_scan and its plain version in bf16 at the serving shape
    and the long prompt, each with its bound.  Returns (ms, plain ms,
    bound ms, bound by) at the serving shape and {case: ms} at both."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    rows = []
    for case, iters, plain_iters in ((SCAN_CASES[0], 200, 20),
                                     (SCAN_CASES[1], 20, 2)):
        args = scan_inputs(case, torch.bfloat16, dev, seed=2)
        ms = time_ms(lambda: selective_scan_cuda(*args), iters)
        plain_ms = time_ms(lambda: ref.selective_scan_ref(*args),
                           plain_iters, warmup=1)
        b_ms, b_by, parts = scan_bound(case, 2)
        log(f"[time] selective_scan {scan_label(case, torch.bfloat16)}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}; " + ", ".join(
                f"{k} {v:.6f} ms" for k, v in parts.items()) + ")")
        rows.append((ms, plain_ms, b_ms, b_by))
        del args
    return rows[0], {c: r[0] for c, r in zip(SCAN_CASES[:2], rows)}


def model_check(arch: str, dev, cache_keys, exact=(), changes=None,
                batch: int = 2) -> None:
    """``arch`` with 2 layers at full width (or as ``changes`` set it):
    the card against the port's CPU path on the same weights (drawn on
    the card from seed 0, cast once to bf16 where the forward computes
    in bf16), teacher-forced on the CPU's greedy tokens for 8 steps (the
    prefill and 7 decodes) of ``batch`` prompts of 64 tokens (after the
    vlm family's patch embeddings, beside the audio family's frames,
    random bf16).  Logits and each cache's ``cache_keys`` (of the layers
    that have them, and the audio family's per-layer encoder K/V) within
    MODEL_TOL of their largest magnitude, its ``exact`` keys equal; the
    card's argmax equal to the CPU's wherever the CPU's top-2 gap
    exceeds twice that bound.  With MoE layers, a batch row is held
    until the card and the CPU send one of its tokens to other experts,
    which they may do only on a near-tie of the router (ROADMAP C3); at
    least one row is held to the end."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.models import moe, registry
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(get_arch(arch), **(changes or {"num_layers": 2}))
    p_dev = registry.serving_params(registry.init_params(
        torch.Generator(device=dev).manual_seed(0), cfg2))
    p_cpu = tree_to(p_dev, "cpu")
    g_cpu = torch.Generator().manual_seed(1)
    inputs = {"tokens": torch.randint(0, cfg2.vocab_size, (batch, 64),
                                      generator=g_cpu)}
    inputs.update(registry.stub_inputs(cfg2, batch, g_cpu))
    context = 64 + cfg2.num_prefix_tokens + 8
    prefill2, decode2 = (registry.prefill_fn(cfg2),
                         registry.decode_fn(cfg2, context))
    routes = {"cpu": [], "card": []}
    cpu_moe = {id(lp["moe"]) for lp in p_cpu["blocks"] if "moe" in lp}
    apply_moe = moe.apply_moe

    def recording(cfg_, p_, x_):
        """``moe.apply_moe``, recording the router's probabilities."""
        logits = F.linear(x_.reshape(-1, x_.shape[-1]),
                          p_["router"].to(x_.dtype)).float()
        routes["cpu" if id(p_) in cpu_moe else "card"].append(
            torch.softmax(logits, -1).cpu())
        return apply_moe(cfg_, p_, x_)

    def rerouted(held) -> "torch.Tensor":
        """The rows not ``held`` and those with a token that the two
        sides sent to other experts in the calls since the last look, in
        call order; each such choice in a row held until that call must
        sit on a near-tie of the CPU's router (its k-th and (k+1)-th
        probabilities within MODEL_TOL of the k-th).  A rerouted token
        moves its row's later layers, which may then route elsewhere
        far from a tie: such a row is no longer held."""
        k = cfg2.experts_per_token
        rows = ~held
        assert len(routes["cpu"]) == len(routes["card"])
        for pc, pd in zip(routes["cpu"], routes["card"]):
            top = lambda pr: pr.sort(dim=-1, descending=True, stable=True
                                     ).indices[:, :k].sort(-1).values
            moved = (top(pc) != top(pd)).any(-1).reshape(batch, -1)
            srt = pc.sort(-1, descending=True).values
            gap = ((srt[:, k - 1] - srt[:, k]) / srt[:, k - 1]).reshape(
                batch, -1)
            fresh = moved & ~rows[:, None]
            if bool((gap[fresh] > MODEL_TOL).any()):
                raise AssertionError(f"{arch}: a token routed elsewhere on "
                                     f"the card at gap {gap[fresh]}")
            rows |= moved.any(-1)
        routes["cpu"].clear()
        routes["card"].clear()
        return rows

    errs = dict.fromkeys(("logits",) + tuple(cache_keys), 0.0)
    seen = set()
    decisive = flipped = 0
    equal = True
    held = torch.ones(batch, dtype=torch.bool)

    def layer_pairs(cd, cc):
        """(card, CPU) dicts a layer: the slot caches or states, then
        each top-level per-layer list (the encoder K/V) as one-key
        dicts."""
        pairs = list(zip(cd["layers"], cc["layers"]))
        for key in sorted(set(cd) - {"layers"}):
            pairs += [({key: a}, {key: b}) for a, b in zip(cd[key], cc[key])]
        return pairs

    moe.apply_moe = recording
    try:
        lg_c, c_c = prefill2(p_cpu, inputs, context=context)
        lg_d, c_d = prefill2(p_dev, tree_to(inputs, dev), context=context)
        for i in range(8):
            held = ~rerouted(held)
            if not held.any():
                break
            errs["logits"] = max(errs["logits"],
                                 scaled_err(lg_d[held.to(dev)], lg_c[held]))
            for a, b in layer_pairs(c_d, c_c):
                seen.update(k for k in a if k in b)
                for key in cache_keys:
                    if key in a:
                        errs[key] = max(errs[key], scaled_err(
                            a[key][held.to(dev)], b[key][held]))
                equal = equal and all(torch.equal(a[key].cpu(), b[key])
                                      for key in exact if key in a)
            last = lg_c[:, -1]
            top2 = last.topk(2, dim=-1).values
            sure = (top2[:, 0] - top2[:, 1]
                    > 2 * MODEL_TOL * last.abs().max()) & held
            tok = last.argmax(-1)
            decisive += int(sure.sum())
            flipped += int((lg_d[:, -1].argmax(-1).cpu() != tok)[sure].sum())
            if i < 7:
                lg_c, c_c = decode2(p_cpu, c_c, tok[:, None])
                lg_d, c_d = decode2(p_dev, c_d, tok[:, None].to(dev))
    finally:
        moe.apply_moe = apply_moe
    unseen = sorted((set(cache_keys) | set(exact)) - seen)
    ok = (max(errs.values()) <= MODEL_TOL and flipped == 0 and equal
          and not unseen and bool(held.any())
          and bool(torch.isfinite(lg_d).all()))
    same = f"; {', '.join(exact)} equal {equal}" if exact else ""
    same += f"; in no layer's cache: {unseen}" if unseen else ""
    rows = (f"; rows held to the end {int(held.sum())} of {batch}"
            if cfg2.is_moe else "")
    enc = (f" (+ {cfg2.encoder_layers} encoder layers over "
           f"{cfg2.encoder_seq} frames)" if cfg2.family == "audio" else "")
    log(f"[check] {arch} {cfg2.num_layers} layers{enc} at full width, cuda "
        f"vs cpu (bf16, B={batch}, T=64, 8 steps): max err / scale "
        f"{json.dumps(errs)} (tol {MODEL_TOL}){same}{rows}; argmax equal "
        f"on {decisive - flipped} of {decisive} decisive steps of "
        f"{8 * batch}; "
        f"{time.perf_counter() - t0:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{arch} on the card disagrees with the CPU")
    del p_dev, p_cpu, c_d, lg_d
    torch.cuda.empty_cache()


def serve_path(arch: str, expected, dev, argv=None, cfg=None,
               per_step=None, **serve_kw):
    """Serving ``arch`` at full width, through ``python -m
    repro_torch.launch.serve``'s ``main(argv)``, or its ``serve(cfg,
    **serve_kw)`` for a config the CLI does not name (fewer layers); the
    launch counts reset just before and read just after must be
    ``expected`` (kernel -> launches) at prefill and ``per_step`` (none
    by default) at each decode step, and no other kernel launched.  Its
    peak device memory includes what the earlier phases still hold.
    Returns the launch counts of the whole run."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models import transformer
    held = torch.cuda.memory_allocated(dev)
    at_prefill = {}
    prefill = transformer.prefill

    def counted(*args, **kw):
        """``transformer.prefill``, reading the launch counts after it
        (a launch counts when it is enqueued)."""
        out = prefill(*args, **kw)
        at_prefill.update(build.LAUNCHES)
        return out

    t_wall = time.perf_counter()
    build.reset_launches()
    out = io.StringIO()
    transformer.prefill = counted
    try:
        with contextlib.redirect_stdout(out):
            if cfg is None:
                rc = serve_cli.main(argv)
            else:
                serve_cli.serve(cfg, device=dev, **serve_kw)
                rc = 0
    finally:
        transformer.prefill = prefill
    served = dict(build.LAUNCHES)
    t_wall = time.perf_counter() - t_wall
    lines = out.getvalue().strip().splitlines()
    for line in lines:
        log(f"[serve path] {line}")
    stats = json.loads(lines[-1])
    first = json.loads(next(line for line in lines if line.startswith(
        "[serve] first sequence:")).split(":", 1)[1])
    cfg = cfg or get_arch(arch)
    steps = stats["max_new"]
    decode = {k: n - at_prefill.get(k, 0) for k, n in served.items()}
    want_decode = {k: (per_step or {}).get(k, 0) * steps for k in served}
    log(f"[serve path] {arch} ({cfg.num_layers} layers, B={stats['batch']}, "
        f"prompt {stats['prompt_len']}) launches {served}: at prefill "
        f"{ {k: n for k, n in at_prefill.items() if n} }, in {steps} decode "
        f"steps { {k: n for k, n in decode.items() if n} }; "
        f"{stats['params']} params; peak device memory "
        f"{stats['peak_mem_bytes'] / 1e9:.2f} GB (of which "
        f"{held / 1e9:.2f} GB held by earlier phases); prefill "
        f"{stats['prefill_s']:.4f} s, decode {stats['decode_s']:.4f} s for "
        f"{stats['max_new']} steps ({stats['decode_tok_s']:.1f} tok/s); "
        f"{t_wall:.1f}s with the weights' draw")
    if (rc != 0 or not stats["device"].startswith("cuda")
            or stats["arch"] != arch or stats["layers"] != cfg.num_layers
            or at_prefill != {k: expected.get(k, 0) for k in served}
            or decode != want_decode
            or not all(0 <= t < cfg.vocab_size for t in first)
            or len(first) != min(16, stats["max_new"])
            or not (math.isfinite(stats["prefill_s"])
                    and math.isfinite(stats["decode_s"]))):
        raise AssertionError(f"serving path {arch}: rc {rc}, launches "
                             f"{served}, stats {stats}")
    return served


# phase 5t, LM training: flash_attention's backward at the shapes the
# training path gives it, (B, Sq, Skv, Hq, Hkv, Dh, causal, window,
# prefix_len): gemma-2b's training shape (8 q heads over 1 kv head of
# 256) and its microbatch of 1 (what a step launches: TRAIN_ARGV's
# batch of 2 in 2 microbatches), minicpm-2b's (36 heads of 64), groups
# of 4 at 128, a sliding window, paligemma's prefix-LM, an unmasked
# sequence, and whisper-medium's three at its training microbatch of 1
# (16 heads of 64): the encoder's 1500 frames, the decoder's causal 448
# tokens and its cross-attention, 448 queries over the 1500 frames
GEMMA_TRAIN_FLASH = (2, 1024, 1024, 8, 1, 256, True, 0, 0)
GEMMA_STEP_FLASH = (1, 1024, 1024, 8, 1, 256, True, 0, 0)
MINICPM_TRAIN_FLASH = (2, 1024, 1024, 36, 36, 64, True, 0, 0)
FLASH_BWD_TIMED = (GEMMA_TRAIN_FLASH, GEMMA_STEP_FLASH, MINICPM_TRAIN_FLASH)
FLASH_BWD_CASES = [
    GEMMA_TRAIN_FLASH,
    GEMMA_STEP_FLASH,
    MINICPM_TRAIN_FLASH,
    (2, 1024, 1024, 32, 8, 128, True, 0, 0),
    (2, 1024, 1024, 8, 1, 256, True, 256, 0),
    (2, 320, 320, 8, 1, 256, True, 0, 256),
    (2, 1500, 1500, 16, 16, 64, False, 0, 0),
    (1, 1500, 1500, 16, 16, 64, False, 0, 0),
    (1, 448, 448, 16, 16, 64, True, 0, 0),
    (1, 448, 1500, 16, 16, 64, False, 0, 0),
]
# the bf16 backward's kernels; "sum" (the dK/dV partials' ordered sum)
# runs only where bwd_plan splits a kv tile's work
FLASH_BWD_PHASES = (("dq", ("fa_bwd_dq_tc",)), ("dkdv", ("fa_bwd_dkdv_tc",)),
                    ("sum", ("fa_bwd_sum",)))
# the training paths at full width and depth through ``python -m
# repro_torch.launch.train``, 4 steps of 2 rows in 2 microbatches:
# gemma-2b and rwkv6-3b at 1024 tokens, whisper-medium at its decoder's
# published context of 448 (over its 1500 encoder frames); arch ->
# (argv, layers, d_model, launches a step: each layer's forward twice a
# microbatch under the recompute, its backward once; whisper's 72
# attention calls a forward: 24 encoder, 24 decoder self- and 24
# cross-attention layers)
TRAIN_STEPS = 4
TRAIN_PATHS = {
    "gemma-2b": (["--seq", "1024"], 18, 2048,
                 {"flash_attention": 72, "flash_attention_bwd": 36}),
    "rwkv6-3b": (["--seq", "1024"], 32, 2560,
                 {"wkv6": 128, "wkv6_bwd": 64}),
    "whisper-medium": (["--seq", "448"], 24, 1024,
                       {"flash_attention": 288, "flash_attention_bwd": 144}),
}
# their 2-layer checks on the card against the CPU (B = 2, 2 microbatches,
# S = 128: two of wkv6's 64-step chunks and two of the selective scan's
# saved-state intervals, so both backwards' carries over chunks are held
# against the CPU through the model; gemma-2b's at S = 64, the CPU's
# reference step being most of a check's time): arch -> (config changes,
# fp32 compute, launches); bf16
# held within MODEL_TOL, fp32 within TRAIN_FP32_TOL.  jamba's (mamba +
# MoE, then attention + MLP; 4 experts of full width, a capacity that
# drops nothing) computes in fp32 on both sides: in bf16 a router
# near-tie sends a token to other experts on one side (ROADMAP C3),
# which no tolerance covers.  rwkv6-3b's computes in fp32 too: in bf16
# u's gradient sums the rounding of every token's r, k and v, so its
# update moves by a few percent of its scale from one bf16 path to
# another (~5%: the card's and the CPU's bf16 steps against each other
# and against the CPU's fp32 step, PERF.md)
TRAIN_CHECK = dict(batch=2, seq=128, grad_accum=2)
TRAIN_CHECK_SEQ = {"gemma-2b": 64}
TRAIN_FP32_TOL = 1e-4
TRAIN_CHECKS = {
    "gemma-2b": (dict(num_layers=2), False,
                 {"flash_attention": 8, "flash_attention_bwd": 4}),
    "rwkv6-3b": (dict(num_layers=2), True, {"wkv6": 8, "wkv6_bwd": 4}),
    "jamba-v0.1-52b": (
        dict(JAMBA_CHECK, capacity_factor=2.0), True,
        {"selective_scan": 4, "selective_scan_bwd": 2, "flash_attention": 4,
         "flash_attention_bwd": 2}),
    "whisper-medium": (dict(num_layers=2, encoder_layers=2), False,
                       {"flash_attention": 24, "flash_attention_bwd": 12}),
}
# the recurrences' backwards: wkv6 at (B, T, H), rwkv6-3b's training
# microbatch (what a step launches), B = 2 and about the 64-step chunk;
# the selective scan at (B, T, Di, N, underflow), jamba's training
# microbatch, an odd Di and T with N = 7, N = 32, a Di past a block's 16
# channels with exp(dt a) underflowing (dt 50 at every 5th step, a -100
# at every 3rd channel)
WKV_BWD_STEP = (1, 1024, 40)
WKV_BWD_CASES = [WKV_BWD_STEP, (2, 1024, 40), (1, 64, 40), (1, 65, 40),
                 (1, 128, 40), (1, 129, 40), (3, 200, 4)]
SCAN_BWD_STEP = (1, 1024, 8192, 16, False)
SCAN_BWD_CASES = [SCAN_BWD_STEP, (3, 77, 300, 7, False),
                  (1, 1024, 8192, 32, False), (2, 130, 8200, 16, True)]
WKV_BWD_PHASES = (("A rows", ("wkv6_bwd_rows_kernel",)),
                  ("A cols", ("wkv6_bwd_cols_kernel",)),
                  ("B", ("wkv6_bwd_carry_kernel",)),
                  ("C", ("wkv6_bwd_cross_kernel",)))
SCAN_BWD_PHASES = (("A", ("selective_scan_bwd_chunk_kernel",)),
                   ("B", ("selective_scan_bwd_carry_kernel",)),
                   ("C", ("selective_scan_bwd_sweep_kernel",)),
                   ("sum", ("selective_scan_bwd_sum_kernel",)))


def flash_bwd_bound(case, elem_bytes: int, per_pair: int = 10):
    """(ms, by) for one backward call: q, k, v, o, dO and lse read and
    dq, dk, dv written once; ``per_pair`` Dh operations per kept pair and
    q head (10: the products S, dP, dV, dQ, dK), at the bf16 tensor-core
    peak for bf16 inputs, the fp32 peak for fp32 ones."""
    b, sq, skv, hq, hkv, dh, causal, window, prefix = case
    n_bytes = ((4 * b * sq * hq + 4 * b * skv * hkv) * dh * elem_bytes
               + 4 * b * hq * sq)
    n_ops = (per_pair * dh * kept_pairs(sq, skv, causal, window, prefix)
             * b * hq)
    return bound(n_bytes, n_ops,
                 BF16_FLOP_PER_S if elem_bytes == 2 else FP32_FLOP_PER_S)


def flash_design_ops(dh: int) -> int:
    """Dh operations per kept pair and q head that the kernels do: S and
    dP in both kernels, once a tile at every Dh (at 256 the dK/dV
    kernel's two warpgroups each take half the q columns), 14."""
    return 14


def flash_bwd_inputs(case, dtype, dev, seed=0):
    """q, k, v, the forward kernel's o and lse, and a cotangent dO."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    kw = dict(zip(("causal", "window", "prefix_len"), case[6:]))
    q, k, v = flash_inputs(case, dtype, dev, seed=seed)
    o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    return (q, k, v, o, lse, do), kw


def flash_bwd_checks(dev) -> dict:
    """flash_attention's backward against its plain version (the
    explicit formulas in fp32) on the same o, lse and dO at every
    training case, fp32 within 1e-5 and bf16 within 2^-7 of each
    gradient's largest magnitude (bf16: P and dS rounded for their
    products, the gradients once), a second launch equal bit for bit;
    and the forward's lse within 1e-5 of the plain lse's scale, its
    output with lse bit-equal to its output without (serving's bits).
    Returns the max abs error over dq, dk, dv in bf16 a case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    errs = {}
    for case in FLASH_BWD_CASES:
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            (q, k, v, o, lse, do), kw = flash_bwd_inputs(case, dtype, dev)
            served = flash_attention_cuda(q, k, v, **kw)
            _, want_lse = ref.flash_attention_lse_ref(q, k, v, **kw)
            got = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            again = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
            want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
            torch.cuda.synchronize()
            lse_err = scaled_err(lse, want_lse)
            same_out = torch.equal(o, served)
            err = {n: scaled_err(g, w)
                   for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = (max(err.values()) <= tol and same and lse_err <= 1e-5
                  and same_out
                  and all(g.dtype == dtype and bool(torch.isfinite(g).all())
                          for g in got))
            if dtype == torch.bfloat16:
                errs[case] = max(float((g.float() - w.float()).abs().max())
                                 for g, w in zip(got, want))
            log(f"[check] flash_attention_bwd {flash_label(case, dtype)}: "
                f"max err / scale { {n: float(f'{e:.3g}') for n, e in err.items()} } "
                f"(tol {tol:.3g}), bit-repeatable {same}; forward lse err / "
                f"scale {lse_err:.3g} (tol 1e-05), output with lse equal "
                f"to without {same_out} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"flash_attention_bwd {case} {dtype} "
                                     f"disagrees")
            del q, k, v, o, lse, do, got, again, want
    return errs


def flash_bwd_times(dev, cases=FLASH_BWD_TIMED, iters: int = 20):
    """flash_attention's backward in bf16 (the tensor-core kernels) at
    gemma-2b's training shape and microbatch and minicpm-2b's training
    shape, with CUDA events, beside its plain version, the fp32
    CUDA-core kernels on the same values in fp32, the library's
    ``scaled_dot_product_attention`` backward (``sdpa_bwd_ms``) and the
    bounds (10 Dh operations per kept pair and q head, and the design's
    own count).  Returns ((ms, plain ms, bound ms, bound by, library
    ms), the kernel call) a case."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    rows = []
    for case in cases:
        args, kw = flash_bwd_inputs(case, torch.bfloat16, dev, seed=2)
        call = functools.partial(flash_attention_bwd_cuda, *args, **kw)
        ms = time_ms(call, iters)
        plain_ms = time_ms(lambda: ref.flash_attention_bwd_ref(*args, **kw),
                           max(2, iters // 4))
        fargs = [t.float() for t in args[:4]] + [args[4], args[5].float()]
        fp32_ms = time_ms(lambda: flash_attention_bwd_cuda(*fargs, **kw),
                          max(2, iters // 4))
        lib_ms, lib_device = sdpa_bwd_ms(case, args, iters)
        b_ms, b_by = flash_bwd_bound(case, 2)
        d_ms, d_by = flash_bwd_bound(case, 2, flash_design_ops(case[5]))
        log(f"[time] flash_attention_bwd {flash_label(case, torch.bfloat16)}"
            f": kernel {ms:.4f} ms (tensor cores), fp32 kernel "
            f"{fp32_ms:.4f} ms (CUDA cores, fp32 inputs), plain "
            f"{plain_ms:.4f} ms, library (scaled_dot_product_attention's "
            f"backward) {lib_ms:.4f} ms (device {lib_device:.4f} ms), bound "
            f"{b_ms:.6f} ms ({b_by}, 10 Dh a kept pair and head), the "
            f"design's own work "
            f"{d_ms:.6f} ms ({d_by}, {flash_design_ops(case[5])} Dh)")
        rows.append(((ms, plain_ms, b_ms, b_by, lib_ms), call))
        del fargs
    return rows


def sdpa_bwd_ms(case, args, iters: int) -> tuple:
    """The library's ``scaled_dot_product_attention`` backward on
    ``flash_bwd_inputs``' q, k, v and dO (GQA, ``case``'s mask): one
    forward kept (``retain_graph``), then its backward alone: (CUDA
    events over back-to-back calls, torch.profiler's device time of its
    kernels a call) in ms."""
    import torch
    import torch.nn.functional as F
    q, k, v, _, _, do = args
    lt = [t.transpose(1, 2).detach().requires_grad_(True) for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*lt, enable_gqa=True,
                                         **sdpa_mask(case, q.device))
    dot = do.transpose(1, 2)

    def backward():
        return torch.autograd.grad(out, lt, dot, retain_graph=True)
    return (time_ms(backward, iters),
            phase_ms(backward, (("all", ("",)),), calls=5)["all"])


def log_flash_bwd_phases(case, call, row) -> float:
    """The backward's device time a launch at ``case`` by kernel (dQ,
    dK/dV, the dK/dV sum where the plan splits), from torch.profiler;
    ``row`` is ``flash_bwd_times``' reading of the same call.  Returns
    the device ms."""
    import torch
    ms = phase_ms(call, FLASH_BWD_PHASES, calls=5, busy=True,
                  optional=("sum",))
    total = sum(ms.values())
    log(f"[profile] flash_attention_bwd {flash_label(case, torch.bfloat16)}"
        f": dQ kernel {ms['dq']:.4f} ms, dK/dV kernel {ms['dkdv']:.4f} ms, "
        f"dK/dV sum {ms['sum']:.4f} ms; device {total:.4f} ms a launch "
        f"(dK/dV {ms['dkdv'] / total:.1%}); CUDA events over back-to-back "
        f"wrapper calls {row[0]:.4f} ms; bound {row[2]:.6f} ms ({row[3]})")
    return total


def train_check(dev, arch: str) -> dict:
    """``arch`` with 2 layers at full width (TRAIN_CHECKS): one train
    step, 2 microbatches, the card against the port's CPU path from the
    same fp32 parameters (drawn on the card from seed 0) and batch (bf16
    compute on both, or fp32 where TRAIN_CHECKS says).  The step is the
    clipped gradient itself (lr 1, AdamW's eps 1, no decay: each element
    moves by g / (|g| + 1)), so each parameter's update is held within
    ``tol`` of its largest element (plus the two updated values'
    rounding, 2^-22 of the parameter), the loss, ce and grad_norm within
    ``tol`` relative (MODEL_TOL in bf16, TRAIN_FP32_TOL in fp32); the
    card's launches must be TRAIN_CHECKS' (each layer's forward twice a
    microbatch, the recompute, its backward once), and no other kernel.
    Returns the card's launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import build
    from repro_torch.models import registry, transformer
    from repro_torch.train import optim
    from repro_torch.train.step import make_train_step
    t0 = time.perf_counter()
    changes, fp32, want = TRAIN_CHECKS[arch]
    tol = TRAIN_FP32_TOL if fp32 else MODEL_TOL
    cfg = dataclasses.replace(get_arch(arch), **changes)
    shape = ShapeConfig("check", TRAIN_CHECK_SEQ.get(arch, TRAIN_CHECK["seq"]),
                        TRAIN_CHECK["batch"], "train",
                        grad_accum=TRAIN_CHECK["grad_accum"])
    opt = optim.OptConfig(lr=1.0, warmup_steps=1, total_steps=10, eps=1.0,
                          weight_decay=0.0)
    step = make_train_step(cfg, shape, opt)
    compute = transformer.COMPUTE_DTYPE

    def run(params, batch, dtype):
        transformer.COMPUTE_DTYPE = dtype
        try:
            return step(params, optim.adamw_init(params), batch)
        finally:
            transformer.COMPUTE_DTYPE = compute

    dtype = torch.float32 if fp32 else compute
    p0 = registry.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    before = tree_to(p0, "cpu")       # the CPU step's start (in place)
    start = _copy(p0)                 # both steps' start, on the card
    batch = registry.make_concrete_batch(
        cfg, shape, torch.Generator().manual_seed(1), "train")
    build.reset_launches()
    t_dev = time.perf_counter()
    p_dev, _, m_dev = run(p0, tree_to(batch, dev), dtype)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t_dev
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    t_cpu = time.perf_counter()
    p_cpu, _, m_cpu = run(before, batch, dtype)
    t_cpu = time.perf_counter() - t_cpu
    rel = {k: abs(float(m_dev[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
           for k in ("loss", "ce", "grad_norm")}
    worst, upd_err = update_err(p_dev, p_cpu, start)
    ok = (max(rel.values()) <= tol and upd_err <= tol and launches == want
          and all(math.isfinite(float(m_dev[k])) for k in rel))
    log(f"[check] train step {arch} {cfg.num_layers} layers"
        f"{f' (+ {cfg.encoder_layers} encoder layers)' if cfg.encoder_layers else ''}"
        f" at full width ({'fp32' if fp32 else 'bf16'}), B="
        f"{shape.global_batch} S={shape.seq_len} ga={shape.grad_accum}, "
        f"cuda vs cpu: loss {float(m_dev['loss']):.6f} / "
        f"{float(m_cpu['loss']):.6f}, grad_norm "
        f"{float(m_dev['grad_norm']):.6f} / {float(m_cpu['grad_norm']):.6f}"
        f", relative errs { {k: float(f'{e:.3g}') for k, e in rel.items()} }"
        f", updates' max err / scale {upd_err:.3g} (at {worst}; tol "
        f"{tol}); launches on the card {launches} (want {want}); "
        f"card {t_dev:.2f}s, cpu {t_cpu:.1f}s; "
        f"{time.perf_counter() - t0:.1f}s {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"the {arch} train step on the card disagrees "
                             f"with the CPU")
    del p_dev, p_cpu, p0, before, start
    return launches


def _copy(tree):
    """A parameter tree's copy on its device (the train step updates in
    place)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v) for v in tree]
    return tree.clone()


def update_err(got, want, before) -> tuple:
    """(key path, error) of the parameter whose update ``got`` (on the
    card) is farthest from ``want``'s (on the CPU), both from ``before``
    (on the card): the largest difference less the two updated values'
    rounding (2^-22 of the parameter), over the largest element of
    ``want``'s update.  Taken on the card, one of ``want``'s leaves
    copied there at a time (elementwise, so the same numbers as on the
    CPU)."""
    from repro_torch.train.optim import tree_leaves
    worst, upd_err = "", 0.0
    for (path, d), c, p0 in zip(_leaf_paths(got), tree_leaves(want),
                                tree_leaves(before)):
        c = c.to(d.device)
        scale = float((c - p0).abs().max())
        err = float(((d - c).abs() - 2 ** -22 * c.abs()).clamp(min=0).max()
                    / max(scale, 1e-30))
        if err > upd_err:
            worst, upd_err = path, err
    return worst, upd_err


def _leaf_paths(tree, path=""):
    """(key path, leaf) in ``train.optim.tree_leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaf_paths(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, f"{path}/{i}")
    else:
        yield path, tree


def train_path(dev, arch: str) -> dict:
    """The training CLI, ``--arch ARCH --steps 4 --batch 2 --grad-accum
    2`` (TRAIN_PATHS' sequence), in a child process at full width and
    depth, its step 2 traced (``train_child``).  Its stats line must
    show a finite loss at every step and, per step, TRAIN_PATHS'
    launches and no other kernel.  Prints each step's seconds, the peak
    device memory and where the traced step's kernel time goes: the
    card is busy for the kernel seconds of that step over the mean of
    the untraced warm steps 1 and 3.  Returns the stats."""
    import torch
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    extra, layers, width, per_step = TRAIN_PATHS[arch]
    argv = ["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch", "2",
            "--grad-accum", "2", *extra]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--train-child", *argv], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=600)
    lines = res.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[train path] {line}")
    if res.returncode != 0:
        log(res.stderr[-4000:])
        raise AssertionError(f"train path {arch}: rc {res.returncode}")
    stats, split = json.loads(lines[-2]), json.loads(lines[-1])
    want = {k: v * TRAIN_STEPS for k, v in per_step.items()}
    ok = (stats["device"].startswith("cuda") and stats["layers"] == layers
          and stats["d_model"] == width and len(stats["loss"]) == TRAIN_STEPS
          and all(math.isfinite(x) for x in stats["loss"])
          and stats["launches"] == want)
    log(f"[train path] {arch} {layers} layers at full width, "
        f"{stats['params']} params, B={stats['batch']} S={stats['seq']} "
        f"ga={stats['grad_accum']}: step seconds "
        f"{[round(s, 4) for s in stats['step_s']]}, losses "
        f"{[round(x, 4) for x in stats['loss']]}, peak device memory "
        f"{stats['peak_mem_bytes'] / 1e9:.2f} GB (this process held "
        f"{held / 1e9:.2f} GB beside it), launches {stats['launches']} "
        f"(want {want}); {time.perf_counter() - t0:.1f}s with the start "
        f"and the weights' draw {'OK' if ok else 'FAIL'}")
    if not ok or not split["kernel_s"] > 0:
        raise AssertionError(f"train path {arch}: stats {stats}, traced "
                             f"kernel seconds {split['kernel_s']}")
    warm = (stats["step_s"][1] + stats["step_s"][3]) / 2
    log(f"[train split] {arch}: step 2 traced {stats['step_s'][2]:.4f} s, "
        f"its kernels {split['kernel_s']:.4f} s: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in split["kinds"].items())
        + f"; untraced warm steps 1 and 3 {warm:.4f} s a step, the card "
        f"busy {split['kernel_s'] / warm:.1%} of it; the most: "
        + "; ".join(f"{n[:60]} {v * 1e3:.1f} ms" for n, v in split["top"]))
    return stats


def wkv_bwd_args(case, dtype, dev, with_ds, seed=0, edge=True):
    """``wkv_inputs`` at ``case`` (r, k, v in ``dtype``; edge decays),
    the forward kernel's states, an fp32 cotangent dy and, ``with_ds``,
    dsT."""
    import torch
    from repro_torch.kernels.wkv6 import wkv6_fwd_cuda
    b, t, h = case
    g = torch.Generator(device=dev).manual_seed(seed)
    args = list(wkv_inputs(b, t, h, g, dev, edge=edge))
    args[:3] = [z.to(dtype) for z in args[:3]]
    _, _, states = wkv6_fwd_cuda(*args)
    dy = torch.randn(b, t, h, WKV_N, generator=g, device=dev)
    ds = (torch.randn(b, h, WKV_N, WKV_N, generator=g, device=dev)
          if with_ds else None)
    return args, states, dy, ds


def scan_bwd_args(case, dtype, dev, with_dh, seed=0):
    """``scan_inputs`` at ``case`` (exp(dt a) underflowing where the case
    says), the forward kernel's saved states, an fp32 cotangent dy and,
    ``with_dh``, dhT."""
    import torch
    from repro_torch.kernels.selective_scan import selective_scan_fwd_cuda
    b, t, di, n, underflow = case
    args = scan_inputs((b, t, di, n), torch.float32, dev, seed=seed)
    if underflow:
        args[1][:, ::5] = 50.0
        args[4][::3] = -100.0
    args = [z.to(dtype) if i < 4 else z for i, z in enumerate(args)]
    _, _, states = selective_scan_fwd_cuda(*args)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn(b, t, di, generator=g, device=dev)
    dh = (torch.randn(b, di, n, generator=g, device=dev) if with_dh
          else None)
    return args, states, dy, dh


def recurrence_bwd_checks(dev) -> dict:
    """``wkv6_bwd`` and ``selective_scan_bwd`` against their plain
    versions (explicit reverse sweeps in fp32) on the same operands and
    the forward kernels' states, at every WKV_BWD_CASES and
    SCAN_BWD_CASES case, in fp32 and in bf16 (r, k, v; x, dt, B, C), the
    final state's cotangent given and not: fp32 within 1e-5 and bf16
    within 2^-7 of each gradient's largest magnitude (each rounded
    once), a second launch equal bit for bit.  Returns {name: max abs
    error over the gradients in bf16 at the training microbatch}."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan_bwd_cuda
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda
    runs = ([("wkv6_bwd", c) for c in WKV_BWD_CASES]
            + [("selective_scan_bwd", c) for c in SCAN_BWD_CASES])
    names = {"wkv6_bwd": ("dr", "dk", "dv", "dw", "du", "ds0"),
             "selective_scan_bwd": ("dx", "ddt", "dB", "dC", "da", "dh0")}
    out = {}
    for name, case in runs:
        for dtype, tol, with_ds in ((torch.float32, 1e-5, True),
                                    (torch.float32, 1e-5, False),
                                    (torch.bfloat16, 2 ** -7, True),
                                    (torch.bfloat16, 2 ** -7, False)):
            if name == "wkv6_bwd":
                args, states, dy, ds = wkv_bwd_args(case, dtype, dev, with_ds,
                                                    seed=sum(case))
                kernel, plain = wkv6_bwd_cuda, ref.wkv6_bwd_ref
                label = "B={} T={} H={}".format(*case)
            else:
                args, states, dy, ds = scan_bwd_args(case, dtype, dev,
                                                     with_ds, seed=case[1])
                kernel = selective_scan_bwd_cuda
                plain = ref.selective_scan_bwd_ref
                label = ("B={} T={} Di={} N={}".format(*case[:4])
                         + (" underflowing" if case[4] else ""))
            got = kernel(*args, states, dy, ds)
            again = kernel(*args, states, dy, ds)
            want = plain(*args, dy, ds)
            torch.cuda.synchronize()
            err = {n: scaled_err(g, w)
                   for n, g, w in zip(names[name], got, want)}
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = (max(err.values()) <= tol and same
                  and all(g.dtype == w.dtype and bool(torch.isfinite(g).all())
                          for g, w in zip(got, want)))
            if dtype == torch.bfloat16 and case in (WKV_BWD_STEP,
                                                    SCAN_BWD_STEP):
                out[name] = max(out.get(name, 0.0), max(
                    float((g.float() - w.float()).abs().max())
                    for g, w in zip(got, want)))
            log(f"[check] {name} {label} {str(dtype).split('.')[-1]}, "
                f"final state's cotangent {'given' if with_ds else 'None'}: "
                f"max err / scale { {n: float(f'{e:.3g}') for n, e in err.items()} } "
                f"(tol {tol:.3g}), bit-repeatable {same} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} {case} {dtype} disagrees")
            del args, states, dy, ds, got, again, want
    return out


def wkv_bwd_bound(b, t, h, design: bool = False):
    """(ms, by) for one wkv6 backward: bf16 r, k, v, fp32 w and dy read
    and bf16 dr, dk, dv, fp32 dw written per (b, t, h, n); u, s0 read,
    du, ds0 written once; 12 fp32 operations per (b, t, h, i, j) (the
    states rebuilt, dr, dk, dv, dw and G, 2 each).  ``design``: the work
    ``csrc/wkv6_bwd.cu`` does, its scratch from
    ``kernels/wkv6.py::bwd_scratch_parts``: the rows kernel reads the
    operands twice (forward and backward passes) and S_in, the columns
    kernel r, k, w and dy, phase C k, v, w, S_in and G_out for each
    chunk but the last; the sub-chunk states, Gloc_start and the fp32
    partials written and read once, phase B's G read and written; per
    (b, t, h, i, j) the forward walk (S: 3, dr: 2), the backward's three
    row dots (sigma, kappa, the step of G: 6), the columns' walk (5) and
    phase C's two products (4 for each chunk but the last), and per (b,
    t, h, i) the rows kernel's recurrences (dk, dw, kappa: ~3 SUB a
    step, taken by each of a row's four threads) and v . dy (2 SUB)."""
    from repro_torch.kernels.wkv6 import CHUNK, SUB, bwd_scratch_parts
    elems = b * t * h * WKV_N
    io_in = elems * (3 * 2 + 4 + 4)
    n_bytes = io_in + elems * (3 * 2 + 4) + (
        2 * h * WKV_N + 2 * b * h * WKV_N * WKV_N) * 4
    n_ops = 12 * WKV_N * elems
    if design:
        chunks = -(-t // CHUNK) if t > CHUNK else 1
        carried = elems * (chunks - 1) * CHUNK // max(t, 1)
        parts = bwd_scratch_parts(b, t, h)
        n_bytes += (io_in                        # the backward pass again
                    + elems * (2 + 2 + 4 + 4)    # the columns kernel
                    + carried * (2 + 2 + 4)      # phase C's k, v, w
                    + 2 * b * h * chunks * WKV_N * WKV_N * 4   # S_in twice
                    + 2 * 4 * sum(parts.values())
                    + 2 * 4 * parts["g_start"])  # phase B
        n_ops = (16 * WKV_N * elems + 4 * WKV_N * carried
                 + 4 * 3 * SUB * elems + 2 * SUB * elems)
    return bound(n_bytes, n_ops)


def scan_bwd_bound(case, elem_bytes: int, design: bool = False):
    """(ms, by, {part: ms}) for one selective-scan backward, the largest
    of three times: the bytes (x, dt, B, C read and dx, ddt, dB, dC
    written in their type, dy read in fp32; a, h0 read and da, dh0
    written once in fp32); 18 fp32 operations per (b, t, d, n) (the
    states rebuilt, 3; the sweep, 15) over the fp32 peak; one exp per (b,
    t, d, n) over the SFU's rate, counted as operations.  ``design``: the
    work ``csrc/selective_scan_bwd.cu`` does, its scratch from
    ``kernels/selective_scan.py::bwd_scratch_parts``: phases A and C each
    read the operands and the forward's chunk-start states, A writes the
    sub-chunk starts (C reads them), Gloc and P (B reads both and writes G
    over Gloc, C reads G), the dB, dC and da partials are written and
    read once; per (b, t, d, n) three exps (A's walk, C's walk forward and
    back) and 28 operations (A: the state, P, Gloc and dC's term, 10; C:
    the state, 4, the reverse step, 12; the sums' adds, 2)."""
    from repro_torch.kernels.selective_scan import SAVE, bwd_scratch_parts
    b, t, di, n = case[:4]
    io_in = (2 * b * t * di + 2 * b * t * n) * elem_bytes + b * t * di * 4
    n_bytes = (io_in + (2 * b * t * di + 2 * b * t * n) * elem_bytes
               + (2 * di * n + 2 * b * di * n) * 4)
    n_ops, n_exp = 18 * b * t * di * n, b * t * di * n
    if design:
        parts = bwd_scratch_parts(b, t, di, n)
        n_bytes += (io_in + 2 * b * (-(-t // SAVE) - 1) * di * n * 4
                    + 4 * (2 * parts["checkpoints"] + 4 * parts["g_carry"]
                           + 2 * parts["decay"] + 2 * parts["db_partials"]
                           + 2 * parts["dc_partials"]
                           + 2 * parts["da_partials"]))
        n_ops, n_exp = 28 * b * t * di * n, 3 * b * t * di * n
    parts = {"bytes": n_bytes / HBM_BYTES_PER_S * 1e3,
             "fp32": n_ops / FP32_FLOP_PER_S * 1e3,
             "exp": n_exp / SFU_EXP_PER_S * 1e3}
    top = max(parts, key=parts.get)
    return (parts[top], "bytes" if top == "bytes" else "operations",
            parts)


def recurrence_bwd_times(dev) -> dict:
    """``wkv6_bwd`` and ``selective_scan_bwd`` in bf16 at the training
    microbatches, with CUDA events, beside their plain versions, autograd
    through the plain forwards (forward and backward), the bounds and the
    designs' own counts; no PyTorch call computes either function
    (library: none).  Returns {name: {timing: (ms, plain ms, bound ms,
    bound by), autograd_ms, design_ms, design_by, shape, call}}."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.selective_scan import selective_scan_bwd_cuda
    from repro_torch.kernels.wkv6 import wkv6_bwd_cuda
    rows = {}
    for name in ("wkv6_bwd", "selective_scan_bwd"):
        if name == "wkv6_bwd":
            case = WKV_BWD_STEP
            args, states, dy, _ = wkv_bwd_args(case, torch.bfloat16, dev,
                                               False, seed=2, edge=False)
            kernel, plain, fwd = wkv6_bwd_cuda, ref.wkv6_bwd_ref, ref.wkv6_ref
            (b_ms, b_by), (d_ms, d_by) = (wkv_bwd_bound(*case),
                                          wkv_bwd_bound(*case, design=True))
            label = "B={} T={} H={} bf16".format(*case)
        else:
            case = SCAN_BWD_STEP
            args, states, dy, _ = scan_bwd_args(case, torch.bfloat16, dev,
                                                False, seed=2)
            kernel = selective_scan_bwd_cuda
            plain, fwd = ref.selective_scan_bwd_ref, ref.selective_scan_ref
            b_ms, b_by, _ = scan_bwd_bound(case, 2)
            d_ms, d_by, _ = scan_bwd_bound(case, 2, design=True)
            label = "B={} T={} Di={} N={} bf16".format(*case[:4])
        call = functools.partial(kernel, *args, states, dy)
        ms = time_ms(call, 20)
        # the plain versions take ~1 s a call: one timed call after one
        # warm-up
        plain_ms = time_ms(lambda: plain(*args, dy), 1, warmup=1)

        def autograd():
            leaves = [z.detach().requires_grad_(True) for z in args]
            y, _ = fwd(*leaves)
            return torch.autograd.grad(y, leaves, dy)
        autograd_ms = time_ms(autograd, 1, warmup=1)
        log(f"[time] {name} {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f}"
            f" ms, autograd through the plain forward {autograd_ms:.4f} ms, "
            f"library none, bound {b_ms:.6f} ms ({b_by}), the design's own "
            f"work {d_ms:.6f} ms ({d_by})")
        rows[name] = dict(timing=(ms, plain_ms, b_ms, b_by),
                          autograd_ms=autograd_ms, design_ms=d_ms,
                          design_by=d_by, shape=label, call=call)
        del args, states, dy
    return rows


def log_bwd_phases(name: str, row: dict, phases) -> dict:
    """A recurrence backward's device ms a launch by phase
    (``phase_ms`` over 5 calls queued behind a spin of the card, so a
    wrapper whose host time nears its kernels' is timed back to back),
    logged beside its CUDA events, bound and the design's own work;
    sets ``row["device_ms"]``."""
    ms = phase_ms(row["call"], phases, calls=5, busy=True)
    row["device_ms"] = sum(ms.values())
    row["phase_ms"] = ms
    split = ", ".join(f"{phase} {ms[phase]:.4f} ms" for phase, _ in phases)
    log(f"[profile] {name} {row['shape']}: {split}; device "
        f"{row['device_ms']:.4f} ms a launch; CUDA events over back-to-back "
        f"wrapper calls {row['timing'][0]:.4f} ms; bound "
        f"{row['timing'][2]:.6f} ms ({row['timing'][3]}), the design's own "
        f"work {row['design_ms']:.6f} ms ({row['design_by']})")
    return ms


def parent_libs(src: str, names) -> dict:
    """The CUDA sources ``names`` of the package under SRC (an older
    checkout's ``src``) built as this tree's are (one ``nvcc`` each, all
    started together) and loaded: {name: CDLL} for each name SRC has."""
    import ctypes
    from repro_torch.kernels import build
    csrc = Path(src) / "repro_torch" / "csrc"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        if (csrc / f"{name}.cu").exists():
            out = build.BUILD_DIR / f"{name}-parent.so"
            procs[name] = (out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out),
                 str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"parent {name} build failed:\n{text}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def recurrence_parent(name: str, src: str) -> int:
    """``--wkv-parent SRC`` (``name`` ``wkv6_bwd``) and ``--scan-parent
    SRC`` (``selective_scan_bwd``): the ``<name>.cu`` of the package under
    SRC (an older checkout's ``src``; its C entry point takes this tree's
    arguments) against this tree's in bf16 at WKV_BWD_STEP or
    SCAN_BWD_STEP, on the operands and forward states
    ``recurrence_bwd_times`` times: both timed in turns (parent, this
    tree, this tree, parent), each within 2^-7 of each gradient's largest
    magnitude of the plain version (bits not compared: the order of the
    sums differs), then this tree's device time by phase.  The parent
    gets the larger of its first design's scratch and this tree's:
    ``wkv6_bwd``'s 8 row groups' dv partials and du's, or
    ``selective_scan_bwd``'s 16-channel blocks' dB and dC partials and
    da's."""
    import ctypes
    import torch
    from repro_torch.kernels import build, ref
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: " +
        subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    libs = parent_libs(src, (name,))
    if name not in libs:
        raise RuntimeError(f"{src} has no {name}.cu")
    fn = getattr(libs[name], f"{name}_launch")
    fn.argtypes = [build._CTYPE[c] for c in
                   build._SIGNATURES[name][f"{name}_launch"]]
    fn.restype = ctypes.c_int
    if name == "wkv6_bwd":
        from repro_torch.kernels.wkv6 import bwd_scratch_parts, wkv6_bwd_cuda
        b, t, h = case = WKV_BWD_STEP
        args, states, dy, _ = wkv_bwd_args(case, torch.bfloat16, "cuda",
                                           False, seed=2, edge=False)
        outs = [torch.empty_like(z) for z in args[:4]] + [
            torch.empty((h, WKV_N), dtype=torch.float32, device="cuda"),
            torch.empty_like(args[5])]
        floats = max(8 * b * t * h * WKV_N + b * h * WKV_N,
                     sum(bwd_scratch_parts(b, t, h).values()))
        dims, kernel, plain = (b, t, h, 1, 0), wkv6_bwd_cuda, ref.wkv6_bwd_ref
        (b_ms, b_by), (d_ms, d_by) = (wkv_bwd_bound(*case),
                                      wkv_bwd_bound(*case, design=True))
        label, phases, tag = ("B={} T={} H={} bf16".format(*case),
                              WKV_BWD_PHASES, "wkv parent")
    else:
        from repro_torch.kernels.selective_scan import (
            bwd_scratch_parts, selective_scan_bwd_cuda)
        case = SCAN_BWD_STEP
        b, t, di, n = case[:4]
        args, states, dy, _ = scan_bwd_args(case, torch.bfloat16, "cuda",
                                            False, seed=2)
        outs = [torch.empty_like(z) for z in args]
        floats = max(2 * b * -(-di // 16) * t * n + b * di * n,
                     sum(bwd_scratch_parts(b, t, di, n).values()))
        dims, kernel = (b, t, di, n, 1), selective_scan_bwd_cuda
        plain = ref.selective_scan_bwd_ref
        b_ms, b_by, _ = scan_bwd_bound(case, 2)
        d_ms, d_by, _ = scan_bwd_bound(case, 2, design=True)
        label, phases, tag = ("B={} T={} Di={} N={} bf16".format(*case[:4]),
                              SCAN_BWD_PHASES, "scan parent")
    scratch = torch.empty(floats, dtype=torch.float32, device="cuda")

    def parent():
        build.check(fn(*(z.data_ptr() for z in args), states.data_ptr(),
                       dy.data_ptr(), None, *dims,
                       *(z.data_ptr() for z in outs), scratch.data_ptr(),
                       torch.cuda.current_stream().cuda_stream),
                    f"parent {name}")
        return outs

    def this():
        return kernel(*args, states, dy)
    want = plain(*args, dy)
    errs = {}
    for who, call in (("parent", parent), ("this tree", this)):
        got = call()
        torch.cuda.synchronize()
        errs[who] = max(scaled_err(g, x) for g, x in zip(got, want))
    ms = [time_ms(call, 20) for call in (parent, this, this, parent)]
    ok = max(errs.values()) <= 2 ** -7
    log(f"[{tag}] {name} {label}: parent {ms[0]:.4f} / {ms[3]:.4f} ms, "
        f"this tree {ms[1]:.4f} / {ms[2]:.4f} ms; max err / scale against "
        f"the plain version parent {errs['parent']:.3g}, this tree "
        f"{errs['this tree']:.3g} (tol {2 ** -7:.3g}) "
        f"{'OK' if ok else 'FAIL'}")
    log_bwd_phases(name, dict(call=this, shape=label,
                              timing=(ms[1], None, b_ms, b_by),
                              design_ms=d_ms, design_by=d_by), phases)
    return int(not ok)


def flash_parent(src: str) -> int:
    """``--flash-parent SRC``: the kernels of the package under SRC (an
    older checkout's ``src``) against this tree's.  The forward (its
    launch with or without the lse pointer, as SRC's source declares
    it), without and with lse, at flash_attention's shapes (phases 5b
    and 5i) and the backward's in fp32 and bf16: the outputs must be
    equal bit for bit.  The backward, where SRC has one (its first
    launch signature, without the dK/dV plan), in bf16 at
    FLASH_BWD_TIMED: both timed in turns (parent, this tree, this tree,
    parent) beside SDPA's backward, each within 2^-7 of each gradient's
    largest magnitude of the plain version (bits not compared: the
    group's summation order differs)."""
    import ctypes
    import torch
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    csrc = Path(src) / "repro_torch" / "csrc"
    libs = parent_libs(src, ("flash_attention", "flash_attention_bwd"))
    fn = libs["flash_attention"].flash_attention_launch
    with_lse = re.search(r"flash_attention_launch\([^)]*\blse\b",
                         (csrc / "flash_attention.cu").read_text())
    fn.argtypes = ([ctypes.c_void_p] * (5 if with_lse else 4)
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    cases = FLASH_CASES + ZOO_FLASH_CASES + FLASH_BWD_CASES
    bad = 0
    for case in cases:
        b, sq, skv, hq, hkv, dh = case[:6]
        kw = dict(zip(("causal", "window", "prefix_len"), case[6:]))
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(case, dtype, "cuda")
            old = torch.empty_like(q)
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           old.data_ptr(), *([None] if with_lse else []),
                           b, sq, skv, hq, hkv, dh,
                           int(dtype == torch.bfloat16), *map(int, case[6:]),
                           1.0 / math.sqrt(dh),
                           torch.cuda.current_stream().cuda_stream),
                        "parent flash_attention")
            new = flash_attention_cuda(q, k, v, **kw)
            with_lse_out, _ = flash_attention_cuda(q, k, v, return_lse=True,
                                                   **kw)
            torch.cuda.synchronize()
            same = torch.equal(old, new) and torch.equal(new, with_lse_out)
            bad += not same
            log(f"[flash parent] {flash_label(case, dtype)}: this tree's "
                f"output (without and with lse) equal to {src}'s bit for "
                f"bit {same}")
    log(f"[flash parent] {len(cases) * 2 - bad} of {len(cases) * 2} equal")
    if "flash_attention_bwd" not in libs:
        return int(bad > 0)

    bwd = libs["flash_attention_bwd"].flash_attention_bwd_launch
    bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                    + [ctypes.c_float, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    for case in FLASH_BWD_TIMED:
        b, sq, skv, hq, hkv, dh = case[:6]
        args, kw = flash_bwd_inputs(case, torch.bfloat16, "cuda", seed=2)
        outs = [torch.empty_like(t) for t in args[:3]]
        delta = torch.empty((b, hq, sq), dtype=torch.float32, device="cuda")

        def parent():
            build.check(bwd(*(t.data_ptr() for t in args), *(
                t.data_ptr() for t in outs), delta.data_ptr(), b, sq, skv,
                hq, hkv, dh, 1, *map(int, case[6:]), 1.0 / math.sqrt(dh),
                torch.cuda.current_stream().cuda_stream),
                "parent flash_attention_bwd")
            return outs

        def this():
            return flash_attention_bwd_cuda(*args, **kw)
        want = ref.flash_attention_bwd_ref(*args, **kw)
        errs = {}
        for label, call in (("parent", parent), ("this tree", this)):
            got = call()
            torch.cuda.synchronize()
            errs[label] = max(scaled_err(g, w) for g, w in zip(got, want))
        ms = [time_ms(call, 20) for call in (parent, this, this, parent)]
        lib_ms, lib_device = sdpa_bwd_ms(case, args, 20)
        ok = max(errs.values()) <= 2 ** -7
        bad += not ok
        log(f"[flash parent] flash_attention_bwd "
            f"{flash_label(case, torch.bfloat16)}: parent {ms[0]:.4f} / "
            f"{ms[3]:.4f} ms, this tree {ms[1]:.4f} / {ms[2]:.4f} ms, SDPA's "
            f"backward {lib_ms:.4f} ms (device {lib_device:.4f} ms); max err "
            f"/ scale against the plain version parent "
            f"{errs['parent']:.3g}, this tree {errs['this tree']:.3g} (tol "
            f"{2 ** -7:.3g}) "
            f"{'OK' if ok else 'FAIL'}")
        del args, outs, delta, want
    return int(bad > 0)


def zoo_phase(dev) -> dict:
    """Phase 5i, the rest of the LM zoo: ``flash_attention`` against its
    plain version at ``ZOO_FLASH_CASES``, timed at whisper's encoder and
    paligemma's prefix-LM prefill; the 2-layer full-width model checks of
    ``ZOO_CHECKS``; then each of ``ZOO_ARCHS`` served at full width (B=4,
    prompt 64, 32 new tokens; phi3.5-moe with ``PHI_LAYERS`` layers), its
    weights freed before the next is drawn: one ``flash_attention``
    launch a self-attention layer at prefill (whisper's also one an
    encoder layer and one a cross-attention), none in decode but
    whisper's cross-attention, one a decoder layer a step, and no other
    kernel.  Returns the check's error, the two timings (as
    ``flash_times``) and each arch's launch counts."""
    import torch
    from repro_torch.configs import get_arch
    t0 = time.perf_counter()
    err = flash_checks(dev, ZOO_FLASH_CASES)
    timing = flash_times(dev, ((WHISPER_ENC_FLASH, 20),
                               (PALIGEMMA_FLASH, 200)))
    for arch, (keys, changes, batch) in ZOO_CHECKS.items():
        model_check(arch, dev, keys, exact=("pos", "idx"), changes=changes,
                    batch=batch)
    served = {}
    for arch in ZOO_ARCHS:
        gc.collect()                  # the last arch's weights are gone
        torch.cuda.empty_cache()
        cfg = get_arch(arch)
        prefill = {"flash_attention": cfg.num_layers}
        per_step = None
        if cfg.family == "audio":
            prefill["flash_attention"] += cfg.encoder_layers + cfg.num_layers
            per_step = {"flash_attention": cfg.num_layers}
        if arch == PHI:
            cfg = dataclasses.replace(cfg, num_layers=PHI_LAYERS)
            prefill = {"flash_attention": PHI_LAYERS}
            served[arch] = serve_path(arch, prefill, dev, cfg=cfg,
                                      batch=4, prompt_len=64, max_new=32,
                                      temperature=0.0, seed=0)
        else:
            served[arch] = serve_path(arch, prefill, dev, per_step=per_step,
                                      argv=["--arch", arch] + ZOO_SERVE_ARGV)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[zoo] phase 5i in {time.perf_counter() - t0:.1f}s")
    return {"err": err, "timing": timing, "served": served}


def probe_bounds(n_bytes: float, s_rows: int) -> tuple:
    """((ms, by) of the kernel's design, (ms, by) as fp32) for the
    packed probe over ``s_rows`` samples moving ``n_bytes``.  The design:
    conv2 and fc1 as 3 TF32 passes at the TF32 tensor-core peak, conv1
    and fc2 at the fp32 peak; the kernel is measured against it.  As
    fp32: every multiply-add at the fp32 CUDA-core peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = s_rows * (3 * PROBE_TC_FLOP / TF32_FLOP_PER_S
                      + PROBE_CC_FLOP / FP32_FLOP_PER_S)
    design = (max(t_bytes, t_ops) * 1e3,
              "bytes" if t_bytes >= t_ops else "operations")
    return design, bound(n_bytes, s_rows * PROBE_FLOP_PER_SAMPLE)


def probe_bound(s_rows: int, n: int, params) -> tuple:
    """``probe_bounds`` for the packed probe alone: images, labels, seg
    read, (N,) counts read and losses written, the CNN's weights read
    once."""
    param_bytes = sum(t.numel() * 4 for t in params.values())
    return probe_bounds(s_rows * (28 * 28 * 4 + 8) + n * 8 + param_bytes,
                        s_rows)


# the profiler's warm-up step and the idle pads of its measured step:
# in a process that has run the earlier phases, a session's trace lacked
# the kernels of its first ~70-80 ms (the large fleet's probe its split
# and conv, 67 ms, also after a warm-up step; selective_scan's 5 calls
# at T = 4096 all of them), so tracing runs PROFILE_WARMUP_S before the
# measured step and the measured calls start and end PROFILE_PAD_S
# inside it
PROFILE_WARMUP_S = 0.5
PROFILE_PAD_S = 0.25
PROFILE_ATTEMPTS = 3
# ``busy`` traces: the card spins at least this long (cycles at the
# H100's 1.98 GHz boost, so a slower clock only spins longer) plus twice
# the calls' host time (at most BUSY_SPIN_MAX_S) before the measured
# calls, which queue behind it
BUSY_SPIN_S, BUSY_SPIN_MAX_S = 0.02, 0.5
SPIN_CYCLES_PER_S = 1.98e9


def phase_ms(fn, phases, calls: int = 1, *, optional=(),
             busy: bool = False) -> dict:
    """Device ms of each phase per call of ``fn`` (mean over ``calls``
    calls), summed by kernel name from ``torch.profiler``'s CUDA
    activity; ``phases`` is ((phase, kernel name prefixes), ...).  The
    session traces a warm-up step of ``fn`` calls for at least
    ``PROFILE_WARMUP_S`` (its events dropped), then the ``calls``
    calls, padded by ``PROFILE_PAD_S`` of idle on each side, as its one
    active step.

    A trace counts only if every phase not named in ``optional`` shows
    at least ``calls`` kernels (each call launches each phase's kernels;
    a session that dropped part of its calls shows fewer) and, with
    ``busy``, if the traced total is at least half the CUDA events' time
    of the same calls.  With ``busy`` the calls queue behind a spin of
    the card (``BUSY_SPIN_S`` and the warm-up's longest host time of
    ``calls`` calls), so they run back to back whatever the host's
    speed: a wrapper whose host time nears its kernels' (the bf16
    backward's) would otherwise leave the card idle between calls, and
    the events would time the host.  A trace that fails is taken again,
    ``PROFILE_ATTEMPTS`` times in all, and the last failure raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        traces = []
        host_s = 0.0
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traces.append(p.key_averages())
                     ) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < PROFILE_WARMUP_S:
                t1 = time.perf_counter()
                fn()
                host_s = max(host_s, time.perf_counter() - t1)
                torch.cuda.synchronize()
            prof.step()
            time.sleep(PROFILE_PAD_S)
            if busy:
                torch.cuda._sleep(int(SPIN_CYCLES_PER_S * min(
                    BUSY_SPIN_MAX_S, BUSY_SPIN_S + 2 * calls * host_s)))
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
        event_ms = start.elapsed_time(end) / calls
        out = dict.fromkeys((name for name, _ in phases), 0.0)
        seen = dict.fromkeys(out, 0)
        for ev in (traces[0] if traces else ()):
            t = getattr(ev, "device_time_total", None)
            if t is None:
                t = getattr(ev, "cuda_time_total", 0.0)
            key = ev.key[5:] if ev.key.startswith("void ") else ev.key
            for name, keys in phases:
                if key.startswith(keys):
                    out[name] += t / 1e3 / calls
                    seen[name] += ev.count
        short = [name for name in out
                 if name not in optional and seen[name] < calls]
        total = sum(out.values())
        if not short and not (busy and total < 0.5 * event_ms):
            return out
        log(f"[profile] attempt {attempt + 1}: torch.profiler saw "
            f"{seen} kernels for {calls} calls (phases short: {short}), "
            f"device {total:.4f} ms a call against CUDA events "
            f"{event_ms:.4f} ms")
    raise AssertionError(
        f"torch.profiler's trace failed {PROFILE_ATTEMPTS} times for "
        f"{[name for name, _ in phases]}: the last saw {seen} kernels for "
        f"{calls} calls (phases short: {short}), device {total:.4f} ms a "
        f"call against CUDA events {event_ms:.4f} ms")


def log_probe_phases(label: str, fn, event_ms: float) -> None:
    ms = phase_ms(fn, PROBE_PHASES, busy=True)
    total = sum(ms.values())
    log(f"[profile] {label}: " + ", ".join(
        f"{k} {v:.4f} ms ({100 * v / total:.1f}%)" for k, v in ms.items())
        + f"; total {total:.4f} ms; CUDA events over back-to-back calls "
        f"{event_ms:.4f} ms")


def probe_loss_phase(dev, big, big_probe, bfeats0, main_probe, feats_main):
    """``probe_loss`` against its plain version at the fast profile's
    whole pack, ranks 1 and 3's regions of the large fleet's 4-way pack
    and an odd S and N: within 1e-5 of the largest loss (fp32 sums in
    another order) and bit-repeatable.  Its LF equals ``probe_fuzzy``'s
    on the same pack bit for bit (shared phases 0-4, the same mean), and
    a region's LF equals the whole pack's for the region's clients, also
    behind 77 more padding rows (phase 4 sums a client's rows in an
    order set by its rows alone).  Timed at rank 1's region (the mesh
    path's shape) and the whole pack.  Returns ((ms, plain ms, bound
    ms, by) at the region, the max abs error at the region)."""
    import torch
    from repro_torch.kernels import ops, ref
    params = big_probe[0]
    n_big = big.n
    counts = big_probe[4]
    regions = {d: big.probe_region(4, d) for d in (1, 3)}
    g = torch.Generator(device=dev).manual_seed(17)
    n_odd, s_odd = 7, 1001
    seg_odd = torch.randint(0, n_odd + 1, (s_odd,), device=dev, generator=g,
                            dtype=torch.int32).sort().values
    odd = (main_probe[0],
           torch.randn(s_odd, 28, 28, 1, device=dev, generator=g),
           torch.randint(0, 10, (s_odd,), device=dev, generator=g,
                         dtype=torch.int32), seg_odd,
           torch.bincount(seg_odd, minlength=n_odd + 1)[:n_odd].int())
    cases = [("fast profile whole pack", main_probe[:5], main_probe[4].shape[0]),
             ("large fleet 4-way rank 1 region",
              (params, *regions[1], counts), n_big),
             ("large fleet 4-way rank 3 region",
              (params, *regions[3], counts), n_big),
             (f"odd S={s_odd} N={n_odd}", odd, n_odd)]
    err_region = None
    lfs = {}
    for label, inputs, n in cases:
        lf = ops.probe_loss(*inputs, n_clients=n)
        again = ops.probe_loss(*inputs, n_clients=n)
        want = ref.probe_loss_ref(*inputs, n)
        torch.cuda.synchronize()
        err = scaled_err(lf, want)
        same = torch.equal(lf, again)
        ok = err <= 1e-5 and same and bool(torch.isfinite(lf).all())
        if label.endswith("rank 1 region"):
            err_region = float((lf - want).abs().max())
        lfs[label] = lf
        log(f"[check] probe_loss {label} S={inputs[1].shape[0]} N={n}: max "
            f"err / scale {err:.3g} (scale {float(want.abs().max()):.4g}, "
            f"tol 1e-5), bit-repeatable {same} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"probe_loss {label} disagrees")
    same_fused = torch.equal(lfs["fast profile whole pack"], feats_main[:, 3])
    region_same = {}
    for d in (1, 3):
        ids = list(range(d * (-(-n_big // 4)),
                         min((d + 1) * (-(-n_big // 4)), n_big)))
        lf = lfs[f"large fleet 4-way rank {d} region"]
        region_same[d] = torch.equal(lf[ids], bfeats0[ids, 3])
    ims, lbs, seg = regions[1]
    lead = 77
    shifted = ops.probe_loss(
        params, torch.cat([torch.zeros(lead, 28, 28, 1, device=dev), ims]),
        torch.cat([torch.zeros(lead, dtype=torch.int32, device=dev), lbs]),
        torch.cat([torch.full((lead,), n_big, dtype=torch.int32,
                              device=dev), seg]), counts, n_clients=n_big)
    same_shift = torch.equal(shifted,
                             lfs["large fleet 4-way rank 1 region"])
    ok = same_fused and all(region_same.values()) and same_shift
    log(f"[check] probe_loss LF bit-equal to probe_fuzzy's on the fast "
        f"pack {same_fused}; each region's LF bit-equal to the whole "
        f"large-fleet pack's (probe_fuzzy) for its clients {region_same}; "
        f"rank 1's region behind {lead} more rows bit-equal {same_shift} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("probe_loss is not offset-invariant or "
                             "disagrees with probe_fuzzy's LF")
    rows = []
    for label, inputs, n, iters in (
            ("large fleet 4-way rank 1 region", cases[1][1], n_big, 5),
            ("fast profile whole pack", cases[0][1], cases[0][2], 20)):
        ms = time_ms(lambda: ops.probe_loss(*inputs, n_clients=n), iters)
        plain_ms = time_ms(lambda: ref.probe_loss_ref(*inputs, n), iters,
                           warmup=1)
        (b_ms, b_by), (f_ms, f_by) = probe_bound(inputs[1].shape[0], n,
                                                 params)
        log(f"[time] probe_loss {label} S={inputs[1].shape[0]} N={n}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}; 3xTF32 design), fp32 bound "
            f"{f_ms:.6f} ms ({f_by})")
        rows.append((ms, plain_ms, b_ms, b_by))
    return rows[0], err_region


def nccl_world_one(dev, sim, params0, fields0, fast0) -> None:
    """``selection_prefix_sharded`` through a one-rank NCCL group (the
    gather seam) on the fast profile's round 0: pos, evals and mask
    bit-equal to the single-device prefix on the card; ``probe_loss``,
    ``fuzzy_eval`` and ``neighbor_elect`` launch once each and
    ``probe_fuzzy`` never."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.fl import pipeline
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import ClientMesh
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = ClientMesh(0, 1, dev, "nccl")
            build.reset_launches()
            got = pipeline.selection_prefix_sharded(
                sim.statics, params0, 0, fields0, cfg=sim.stage_cfg,
                mesh=mesh)
            torch.cuda.synchronize()
            counts = dict(build.LAUNCHES)
        finally:
            dist.destroy_process_group()
    same = {k: torch.equal(got[k], fast0[k])
            for k in ("pos", "feats", "evals", "mask", "survivors",
                      "n_selected", "mean_eval_selected")}
    want = {"probe_loss": 1, "fuzzy_eval": 1, "neighbor_elect": 1}
    ok = all(same.values()) and counts == {k: want.get(k, 0) for k in counts}
    log(f"[check] NCCL world size 1, fast profile round 0: bit-equal to the "
        f"single-device prefix {same}; launches {counts} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the one-rank NCCL prefix differs")


def round0_training(sim, mesh=None):
    """Round 0's mask and training half (cohort gather, local SGD,
    FedAvg) from the simulation's initial params, in fp32 and in fp64
    (images and params cast; FedAvg sums in fp32 either way), on the
    mesh's sharded trainer when ``mesh`` is given."""
    import numpy as np
    import torch
    from repro_torch.fl import pipeline
    fields = sim.round_fields(0)
    host = sim._host(sim.selection_state(0, fields))
    out = {"mask0": host["mask"]}
    c = sim.cfg
    kw = dict(epochs=c.local_epochs, batch_size=c.batch_size, lr=c.lr)
    for dtype, np_dtype in ((torch.float32, np.float32),
                            (torch.float64, np.float64)):
        params = {k: v.to(dtype) for k, v in sim.params.items()}
        groups = pipeline.device_groups(
            [dataclasses.replace(g, images=g.images.astype(np_dtype))
             for g in sim.groups], sim.device)
        perms = lambda i: fields.perms[i]
        if mesh is None:
            new = pipeline.aggregate(params, pipeline.train_groups(
                params, groups, sim._group_steps, host["survivors"], perms,
                **kw))
        else:
            new = pipeline.aggregate_sharded(
                params, pipeline.train_groups_sharded(
                    params, groups, sim._group_steps, host["survivors"],
                    perms, mesh, **kw))
        out.update({f"{np_dtype.__name__}.{k}": v.cpu().numpy()
                    for k, v in new.items()})
    return out


def fast_round0_rank(mesh):
    """One rank of the fast profile's 2-way mesh: ``round0_training``
    under deterministic algorithms."""
    import torch
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    sim = FLSimulation(fast_config_dcs(1),
                       run=RunConfig(mesh=f"clients={mesh.size}"), mesh=mesh)
    return round0_training(sim, mesh)


def mesh_fast(dev) -> None:
    """The fast profile on 2 ranks of the one card (gloo, collectives
    staged through host memory).  The CLI for 2 rounds: its banner names
    gloo, each rank launches
    ``probe_loss``, ``fuzzy_eval`` and ``neighbor_elect`` (the gather
    seam) and never ``probe_fuzzy``, and round 0's row equals the
    single-device run's on every count and ``mean_eval_selected`` bit
    for bit (round 1 starts from params that FedAvg summed in another
    order: a reading); beside it the same CLI with ``--multihost 2``
    (``mesh_multihost``).  Then 2 spawned ranks for round 0: masks equal
    the single-device round's, and the sharded training half and FedAvg
    land within 1e-6 of the single-device one in fp64, where no ReLU or
    max-pool kink flips (the fp32 gap is a reading: a one-ulp nudge of
    the start moves round 0's fp32 params by ~4e-3, phase 5)."""
    import numpy as np
    import torch
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.launch.mesh import spawn_ranks
    # the single-host CLI, the --multihost 2 CLI and the 2 spawned ranks
    # run together (their times are readings; nothing checked depends on
    # them)
    t0 = time.perf_counter()
    clis = {mh: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.fl_sim", "--scheme", "dcs",
         "--rounds", "2", "--mesh", "clients=2",
         *(["--multihost", "2"] if mh else [])],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
        for mh in (False, True)}
    try:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        try:
            single = FLSimulation(fast_config_dcs(2), run=RunConfig(),
                                  device=dev)
            want0 = round0_training(single)
            want = [single.run_round(r) for r in range(2)]
            t1 = time.perf_counter()
            ranks2 = spawn_ranks(fast_round0_rank, 2, dev.type)
            spawn_s = time.perf_counter() - t1
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        outs = {}
        for mh, proc in clis.items():
            stdout, stderr = proc.communicate(timeout=600)
            if proc.returncode != 0:
                log(stderr[-4000:])
                raise AssertionError(f"fl_sim --mesh clients=2"
                                     f"{' --multihost 2' if mh else ''} "
                                     f"exited {proc.returncode}")
            outs[mh] = stdout
    finally:
        for proc in clis.values():         # the launch's whole tree
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    cli_s = time.perf_counter() - t0
    out = outs[False]
    for line in out.strip().splitlines():
        log(f"[mesh cli] {line}")
    rows = [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]
    ranks = cli_rank_launches(out)
    mesh_multihost(outs[True], rows, ranks)
    keys = ("n_selected", "n_aggregated", "n_straggler", "mean_eval_selected")
    row0 = all(rows[0][k] == want[0][k] for k in keys)
    masks = all(bool((r["mask0"] == want0["mask0"]).all()) for r in ranks2)

    def gap(res, dtype):
        return max(float(np.abs(res[f"{dtype}.{k}"]
                                - want0[f"{dtype}.{k}"]).max())
                   for k in single.params)
    gap64 = max(gap(r, "float64") for r in ranks2)
    gap32 = max(gap(r, "float32") for r in ranks2)
    launch_ok = len(ranks) == 2 and all(
        c["probe_fuzzy"] == 0 and c["probe_loss"] == 2
        and c["fuzzy_eval"] == 2 and c["neighbor_elect"] >= 2 for c in ranks)
    ok = ("backend gloo" in out and row0 and masks and gap64 <= 1e-6
          and launch_ok and len(rows) == 2)
    log(f"[check] mesh clients=2 fast profile: the CLIs and the spawned "
        f"ranks together {cli_s:.1f}s; round 0 "
        f"row bit-equal to single-device {row0}; round 1 counts (a reading: "
        f"params differ after FedAvg) {[rows[1][k] for k in keys]} / "
        f"{[want[1][k] for k in keys]}; 2 spawned ranks ({spawn_s:.1f}s): "
        f"round 0 masks bit-equal {masks}, training + FedAvg params max abs "
        f"gap fp64 {gap64:.3g} (tol 1e-6), fp32 {gap32:.3g} (a reading) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the 2-rank mesh differs from one device")


def cli_rank_launches(out: str) -> list:
    """The kernel launches on each ``[fl_sim] rank`` line of a mesh
    CLI's output, in rank order."""
    return [json.loads(line.split("launches ", 1)[1].split(
        ", host-staged")[0]) for line in out.splitlines()
        if line.startswith("[fl_sim] rank ")]


def mesh_multihost(out: str, rows: list, ranks: list) -> None:
    """``[mesh multihost]``: ``fl_sim --scheme dcs --rounds 2 --mesh
    clients=2 --multihost 2`` on the card (2 launcher processes of one
    rank each, one world over gloo): every row bit-equal to the
    single-host ``--mesh clients=2`` CLI's ``rows``, the banner naming
    gloo and 2 processes, and each of the 2 rank lines the single-host
    ranks' launches ``ranks``."""
    for line in out.strip().splitlines():
        log(f"[mesh multihost] {line}")
    got = [json.loads(line) for line in out.splitlines()
           if line.startswith("{")]
    banner = next((line for line in out.splitlines()
                   if "client mesh" in line), "")
    launches = cli_rank_launches(out)
    same_rows = len(rows) == 2 and got == rows
    ok = (same_rows and "backend gloo" in banner
          and "/ 2 processes" in banner and launches == ranks)
    log(f"[check] mesh multihost: --multihost 2 rows bit-equal to the "
        f"single-host mesh CLI's {same_rows}; banner {banner!r}; rank "
        f"launches equal to the single-host ranks' {launches == ranks} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the 2-process mesh differs from one host")


def fast_config_dcs(n_rounds: int):
    from repro_torch.launch.fl_sim import fast_config
    return fast_config("dcs", n_rounds=n_rounds)


def eval_margin(evals, e_tau: float) -> float:
    """Smallest gap between two evaluations or to E_tau: how close the
    round came to a tie that fp32 rounding could flip (ROADMAP C3)."""
    import numpy as np
    e = np.sort(np.asarray(evals, np.float64))
    gaps = np.diff(e)
    return float(min(np.abs(e - e_tau).min(),
                     gaps.min() if gaps.size else math.inf))


def comm_columns(cfg, n: int, n_selected: int) -> dict:
    """A row's §4.2 columns, computed here from ``core/overhead.py``."""
    from repro_torch.core import overhead as oh
    key = OVERHEAD_KEYS[cfg.scheme]
    p = oh.IoVParams(n_participants=n, clients_per_round=n_selected,
                     round_period_s=cfg.deadline_s,
                     model_bytes=cfg.model_bytes,
                     state_bytes_cfl=cfg.state_bytes,
                     state_bytes_ccs_fuzzy=cfg.eval_bytes,
                     eval_bytes_dcs=cfg.eval_bytes,
                     uplink_bps_best=cfg.network.best_rate_bps,
                     uplink_bps_worst=cfg.network.worst_rate_bps)
    comm = oh.accumulated_time_s(key, cfg.state_interval_s, p)
    return {"state_bytes": oh.state_maintenance_bytes(
                n, cfg.state_bytes if key == "cfl" else cfg.eval_bytes,
                cfg.deadline_s, cfg.state_interval_s),
            "upload_bytes": oh.model_upload_bytes(n_selected,
                                                  cfg.model_bytes),
            "state_time_s": comm - oh.accumulated_time_s(
                "model-only", cfg.state_interval_s, p),
            "comm_time_s": comm}


def paper_round(dev) -> dict:
    """Phase 5e's main path: ``paper_config("dcs")`` round 0 on the card
    through ``drive_rounds`` (the counts reset just before, read just
    after), the full 30 local epochs.  Round 0's prefix against the
    port's CPU plain path on the same fields (evals within 1e-3; masks
    equal unless the CPU's evals hold a near-tie within the gap, C3);
    the launches exactly ``probe_fuzzy`` 1 and ``neighbor_elect`` 1;
    the row's keys the reference's, in order, and its comm columns ==
    ``comm_columns``.  Then the training half alone from the same params
    and survivors, timed, for the ms per local-SGD step.  Returns the
    launches."""
    import numpy as np
    import torch
    from repro_torch.fl import pipeline
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.launch.fl_sim import drive_rounds, paper_config
    t0 = time.perf_counter()
    sim = FLSimulation(paper_config("dcs"), run=RunConfig(), device=dev)
    cpu = FLSimulation(paper_config("dcs"), run=RunConfig(), device="cpu")
    build_s = time.perf_counter() - t0
    params0 = {k: v.clone() for k, v in sim.params.items()}
    cpu.params = {k: v.cpu() for k, v in params0.items()}
    fields = sim.round_fields(0)
    got, want = sim.selection_state(0, fields), cpu.selection_state(0, fields)
    ev_err = float((got["evals"].cpu() - want["evals"]).abs().max())
    margin = eval_margin(want["evals"].numpy(), sim.cfg.e_tau)
    survivors = got["survivors"].cpu().numpy()

    res = drive_rounds(sim, 1)
    row, launches = res["rows"][0], prefix_launches(res["launches"])
    same = bool(np.array_equal(res["mask0"], want["mask"].numpy()))
    cols = comm_columns(sim.cfg, sim.n, row["n_selected"])
    cols_ok = list(row) == ROW_KEYS and all(row[k] == v
                                            for k, v in cols.items())
    launch_ok = launches == {k: int(k in ("probe_fuzzy", "neighbor_elect"))
                             for k in launches}

    c = sim.cfg
    steps = {g.cap: sim._group_steps[gi] * c.local_epochs
             for gi, g in enumerate(sim.groups)
             if survivors[g.client_ids].any()}
    torch.cuda.synchronize()
    t = time.perf_counter()
    trained = pipeline.aggregate(params0, pipeline.train_groups(
        params0, sim.device_groups(), sim._group_steps, survivors,
        lambda i: fields.perms[i], epochs=c.local_epochs,
        batch_size=c.batch_size, lr=c.lr))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    n_steps = sum(steps.values())
    per_step = (f"{1e3 * train_s / n_steps:.4f} ms a local-SGD step"
                if n_steps else "no local-SGD step")
    finite = all(bool(torch.isfinite(v).all()) for v in trained.values())
    log(f"[paper] dcs round 0 (paper_config: {c.local_epochs} local "
        f"epochs, deadline {c.deadline_s} s, caps "
        f"{[g.cap for g in sim.groups]}): {int(survivors.sum())} "
        f"survivor(s); prefix {res['prefix_s'][0]:.4f} s, round "
        f"{res['round_s'][0]:.4f} s; training half alone {train_s:.4f} s "
        f"over {n_steps} steps (by group cap: {steps}), {per_step}; "
        f"simulations built in {build_s:.1f}s (card and CPU)")
    log(f"[paper] row {json.dumps(row)}")
    ok = (ev_err <= 1e-3 and (same or margin <= 2 * ev_err) and cols_ok
          and launch_ok and finite and 0.0 <= row["accuracy"] <= 1.0)
    log(f"[check] paper round 0: prefix cuda vs cpu eval max abs err "
        f"{ev_err:.3g} (tol 1e-3), masks equal {same} (smallest eval "
        f"margin {margin:.3g}); row keys and comm columns == "
        f"core/overhead.py {cols_ok}; launches {launches} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the paper profile's round 0 is wrong")
    return launches


def engines_and_prox(dev) -> None:
    """Phase 5e on the fast profile's round 0, under deterministic
    algorithms: the loop engine against the batched one (fp32 rounds
    through ``run_round``: masks and integer and comm columns equal,
    accuracy and params within 1e-5, ROADMAP C8; rounds 1 and 2 after
    it, a reading; fp64 training halves from the same params and
    survivors: within 1e-6), then FedProx (``prox_mu`` = PROX_MU), the
    card's fp64 training half against the CPU's, within 1e-6."""
    import numpy as np
    import torch
    from repro_torch.fl import pipeline
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig

    def gap(a, b):
        return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)

    def fp64(sim, device):
        return ({k: v.to(device, torch.float64)
                 for k, v in sim.params.items()},
                [dataclasses.replace(g, images=g.images.astype(np.float64))
                 for g in sim.groups])

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        sims = {e: FLSimulation(fast_config_dcs(3), run=RunConfig(engine=e),
                                device=dev) for e in ("batched", "loop")}
        start = {e: fp64(s, dev) for e, s in sims.items()}
        fields = sims["loop"].round_fields(0)
        survivors = sims["loop"]._host(
            sims["loop"].selection_state(0, fields))["survivors"]
        perms = lambda i: fields.perms[i]
        rows = {e: s.run_round(0) for e, s in sims.items()}
        same_mask = bool(np.array_equal(sims["loop"].last_mask,
                                        sims["batched"].last_mask))
        keys = [k for k in ROW_KEYS if k not in ("accuracy",
                                                 "mean_eval_selected")]
        same_rows = all(rows["loop"][k] == rows["batched"][k] for k in keys)
        gap32 = gap(sims["loop"].params, sims["batched"].params)
        acc32 = abs(rows["loop"]["accuracy"] - rows["batched"]["accuracy"])
        # later rounds: fp32 SGD carries the engines' remaining gap on
        later = []
        for rnd in (1, 2):
            r = {e: s.run_round(rnd) for e, s in sims.items()}
            later.append((gap(sims["loop"].params, sims["batched"].params),
                          r["loop"]["accuracy"], r["batched"]["accuracy"]))
        for e, s in sims.items():
            s.params, s.groups = start[e]
        sims["batched"]._train_batched(survivors, perms)
        sims["loop"]._train_loop(survivors, perms)
        gap64 = gap(sims["loop"].params, sims["batched"].params)

        sim, (params64, groups64) = sims["batched"], start["batched"]
        c = sim.cfg

        def prox_half(device, mu):
            params = {k: v.to(device) for k, v in params64.items()}
            return pipeline.aggregate(params, pipeline.train_groups(
                params, pipeline.device_groups(groups64, device),
                sim._group_steps, survivors, perms,
                epochs=c.local_epochs, batch_size=c.batch_size, lr=c.lr,
                prox_mu=mu))
        prox_card = prox_half(dev, PROX_MU)
        prox_gap = gap(prox_card, prox_half("cpu", PROX_MU))
        pull = gap(prox_card, prox_half(dev, 0.0))
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    ok = (same_mask and same_rows and gap64 <= 1e-6 and gap32 <= 1e-5
          and acc32 <= 1e-5 and prox_gap <= 1e-6 and pull > 0.0
          and int(survivors.sum()) > 0)
    log(f"[check] loop vs batched engine, fast round 0 (deterministic): "
        f"masks equal {same_mask}, counts and comm columns equal "
        f"{same_rows}, accuracy {rows['loop']['accuracy']:.4f} / "
        f"{rows['batched']['accuracy']:.4f} (tol 1e-5); params max abs gap "
        f"fp32 {gap32:.3g} (tol 1e-5), fp64 {gap64:.3g} (tol 1e-6); FedProx "
        f"mu {PROX_MU} fp64 cuda vs cpu {prox_gap:.3g} (tol 1e-6), its pull "
        f"from mu = 0 {pull:.3g} {'OK' if ok else 'FAIL'}")
    log("[reading] loop vs batched engine, fp32, rounds 1-2: " + "; ".join(
        f"round {i + 1} params gap {g:.3g}, accuracy {a:.4f} / {b:.4f}"
        for i, (g, a, b) in enumerate(later)))
    if not ok:
        raise AssertionError("the loop engine or FedProx is wrong")


def c8_step_check(dev) -> None:
    """Phase 5e, ROADMAP C8 op by op: one local-SGD step of the fast
    profile's first round-0 survivor trained alone (the loop engine's
    cohort of one) and in its cohort of four (the batched engine's),
    under deterministic algorithms, with the stacked convolutions in the
    card's GEMM form (the port's; every op and gradient within 1e-5 of
    its scale) and as cuDNN's grouped convolution (the CPU's form; a
    reading, since cuDNN picks its algorithms by the group count); for
    each form the convolution kernels the profiler sees in the step
    alone and in the cohort, and the step's device time."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl.pipeline import cohort_bucket
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.models import cnn

    def grouped(x, w, b):
        return F.conv2d(x, w.reshape(-1, *w.shape[2:]), b.reshape(-1),
                        padding=w.shape[-1] // 2, groups=w.shape[0])

    sim = FLSimulation(fast_config_dcs(1), run=RunConfig(), device=dev)
    fields = sim.round_fields(0)
    surv = sim._host(sim.selection_state(0, fields))["survivors"]
    g = sim.groups[0]
    cohort = np.where(surv[g.client_ids])[0]
    idx = np.concatenate([cohort, np.full(
        cohort_bucket(len(cohort)) - len(cohort), cohort[0])])
    b = sim.cfg.batch_size

    def step(c_idx):
        perm = torch.stack([fields.perms[int(g.client_ids[i])][0]
                            for i in c_idx]).to(dev)
        rows = torch.arange(len(c_idx), device=dev)[:, None]
        images = torch.as_tensor(g.images[c_idx], device=dev)[rows, perm]
        labels = torch.as_tensor(g.labels[c_idx], device=dev)[rows, perm]
        p = {k: v[None].expand(len(c_idx), *v.shape).clone()
             .requires_grad_(True) for k, v in sim.params.items()}
        logits = cnn.cnn_forward_stacked(p, images[:, :b])
        loss = cnn.sample_nll(logits, labels[:, :b]).mean(-1)
        grads = torch.autograd.grad(loss.sum(), list(p.values()))
        out = {"logits": logits, "loss": loss}
        out.update({"grad " + k: v for k, v in zip(p, grads)})
        return {k: v.detach()[0] for k, v in out.items()}

    def conv_kernels(c_idx):
        step(c_idx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(c_idx)
            torch.cuda.synchronize()
        names, total, by = set(), 0.0, {}
        for ev in prof.key_averages():
            t = getattr(ev, "device_time_total", None)
            t = getattr(ev, "cuda_time_total", 0.0) if t is None else t
            total += t
            key = ev.key[5:] if ev.key.startswith("void ") else ev.key
            key = key.replace("(anonymous namespace)::", "")
            if any(w in key for w in ("conv", "grad", "winograd", "fprop",
                                      "im2col", "unfold")):
                names.add(re.split(r"[<(]", key)[0][:56])
            if t > 0:
                name = key.split("(")[0][:60]
                n, ms = by.get(name, (0, 0.0))
                by[name] = (n + ev.count, ms + t / 1e3)
        top = sorted(by.items(), key=lambda kv: -kv[1][1])[:8]
        return sorted(names), total / 1e3, "; ".join(
            f"{k} {ms:.4f} ms ({n})" for k, (n, ms) in top)

    from repro_torch.kernels import ops
    gemm, kernel = cnn._stacked_conv_gemm, ops.cohort_gemm
    forms = (("cohort_gemm", gemm, kernel),
             ("plain (cuBLAS)", gemm, cublas_gemm),
             ("grouped cuDNN", grouped, kernel))
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    errs = {}
    try:
        for form, conv, product in forms:
            cnn._stacked_conv_gemm, ops.cohort_gemm = conv, product
            alone, in_cohort = step(idx[:1]), step(idx)
            errs[form] = {k: float((alone[k] - want).abs().max()
                                   / want.abs().max().clamp(min=1e-30))
                          for k, want in in_cohort.items()}
            for label, c_idx in (("alone", idx[:1]), ("cohort", idx)):
                names, ms, top = conv_kernels(c_idx)
                log(f"[c8] {form} step {label} (C={len(c_idx)}): device "
                    f"{ms:.4f} ms; convolution kernels {names}")
                log(f"[c8] {form} step {label}: device time by kernel "
                    f"(launches): {top}")
    finally:
        cnn._stacked_conv_gemm, ops.cohort_gemm = gemm, kernel
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
    for form, e in errs.items():
        worst = max(e, key=e.get)
        log(f"[c8] {form}: one step alone vs in the cohort of {len(idx)}, "
            f"worst scaled gap {e[worst]:.3g} ({worst})"
            + (" (must be 0)" if form == "cohort_gemm" else " (a reading)"))
    if len(idx) < 2 or max(errs["cohort_gemm"].values()) != 0.0:
        raise AssertionError(f"C8/C12: a cohort of one is not bit-equal "
                             f"to the same client in its cohort: "
                             f"{errs['cohort_gemm']}")


C12_ROUNDS = 3


def c12_engines(dev, plain: bool = False) -> list:
    """ROADMAP C12 on the card: ``C12_ROUNDS`` fast ``dcs`` rounds in
    the loop and the batched engine on the same draws, with the default
    algorithms, held to the reference's engine contract
    (``tests/test_engine_parity.py``): masks, ``n_selected``,
    ``n_aggregated`` and ``n_straggler`` equal, accuracy within 1e-5;
    the largest params gap per round logged.  ``plain=True`` runs the
    cohort's products through their plain version (cuBLAS), as a
    reading.  Returns the per-round params gaps."""
    import numpy as np
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.kernels import build, ops
    kernel = ops.cohort_gemm
    if plain:
        ops.cohort_gemm = cublas_gemm
    try:
        sims = {e: FLSimulation(fast_config_dcs(C12_ROUNDS),
                                run=RunConfig(engine=e), device=dev)
                for e in ("loop", "batched")}
        build.reset_launches()
        gaps, report, ok = [], [], True
        for rnd in range(C12_ROUNDS):
            rows = {e: s.run_round(rnd) for e, s in sims.items()}
            same_mask = bool(np.array_equal(sims["loop"].last_mask,
                                            sims["batched"].last_mask))
            same = all(rows["loop"][k] == rows["batched"][k]
                       for k in ("n_selected", "n_aggregated",
                                 "n_straggler"))
            acc = abs(rows["loop"]["accuracy"] - rows["batched"]["accuracy"])
            gap = max(float((sims["loop"].params[k] - sims["batched"]
                             .params[k]).abs().max())
                      for k in sims["loop"].params)
            gaps.append(gap)
            ok = ok and same_mask and same and acc <= 1e-5
            acc_l, acc_b = (rows[e]["accuracy"] for e in ("loop", "batched"))
            report.append(f"round {rnd}: masks equal {same_mask}, counts "
                          f"equal {same}, accuracy {acc_l:.6f} / "
                          f"{acc_b:.6f}, params gap {gap:.3g}, aggregated "
                          f"{rows['loop']['n_aggregated']}")
        launches = build.LAUNCHES["cohort_gemm"]
    finally:
        ops.cohort_gemm = kernel
    tag = "[reading] C12 plain (cuBLAS)" if plain else "[check] C12"
    log(f"{tag} loop vs batched engine, {C12_ROUNDS} fast rounds (default "
        f"algorithms): " + "; ".join(report)
        + f"; cohort_gemm launches {launches}"
        + ("" if plain else f" {'OK' if ok else 'FAIL'}"))
    if not plain and (not ok or launches == 0):
        raise AssertionError("C12: the engines break the reference's "
                             "contract on the card")
    return gaps


def c12_round_times(dev=None) -> dict:
    """The trained rounds' wall time (host clock, synchronised, the
    serial schedule): 4 fast ``dcs`` rounds and 2 paper-profile ``dcs``
    rounds (round 0 trains 1 client, round 1 two), each round's seconds
    with its aggregated count.  Uses only entry points that predate the
    cohort GEMM, so it times an older checkout too (run this file from
    that checkout's root)."""
    import torch
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.launch.fl_sim import (drive_rounds, fast_config,
                                           paper_config)
    dev = dev or torch.device("cuda")
    out = {}
    for label, cfg, n in (("fast", fast_config("dcs", n_rounds=4), 4),
                          ("paper", paper_config("dcs"), 2)):
        sim = FLSimulation(cfg, run=RunConfig(overlap_rounds=False),
                           device=dev)
        res = drive_rounds(sim, n)
        out[label] = [(round(t, 6), r["n_aggregated"])
                      for t, r in zip(res["round_s"], res["rows"])]
    log(f"[time] trained rounds (s, aggregated), {ROOT.name}: "
        f"{json.dumps(out)}")
    return out


def round_profile(dev) -> None:
    """One trained paper-profile round (``paper_config("dcs")``'s round
    1, serial: its 2 clients of 60 samples, 90 local-SGD steps) under
    ``torch.profiler``: wall seconds (the profiler's own host cost in
    them), the card's kernel time and its share of the wall (the rest
    the card idles, waiting on the host), the kernels by device time and
    the host's ops by self time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.launch.fl_sim import paper_config
    sim = FLSimulation(paper_config("dcs"),
                       run=RunConfig(overlap_rounds=False), device=dev)
    sim.run_round(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        row = sim.run_round(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern, busy = {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            key = e.name[5:] if e.name.startswith("void ") else e.name
            key = re.split(r"[(]", key)[0][:48]
            kern[key] = kern.get(key, 0.0) + us
    host = {ev.key[:40]: ev.self_cpu_time_total
            for ev in prof.key_averages() if ev.self_cpu_time_total > 0}
    top_k = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    top_h = sorted(host.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] trained paper round (aggregated {row['n_aggregated']})"
        f": wall {wall:.4f} s under the profiler, card busy "
        f"{busy / 1e6:.4f} s ({busy / 1e6 / wall:.1%}); kernels: "
        + "; ".join(f"{k} {v / 1e3:.2f} ms" for k, v in top_k)
        + "; host self time: "
        + "; ".join(f"{k} {v / 1e3:.2f} ms" for k, v in top_h))


def train_child(argv) -> int:
    """``python3 chip_smoke.py --train-child ARGV``: the training CLI
    (``repro_torch.launch.train``'s main) on ARGV, its step 2 (the
    third) under torch.profiler (the card's activity alone, from the
    step's call until it is synchronised; the step's seconds include the
    trace's processing, the other steps run with no profiler).  After
    the CLI's lines, one JSON line: that step's kernel time on the card
    (each kernel once) by kind (the library's GEMMs, the port's
    hand-written kernels, PyTorch's elementwise kernels, the rest) and
    the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch import train
    ours = ("wkv6", "selective_scan", "fa_", "flash_")
    split, calls = {}, []
    make = train.make_train_step

    def make_traced(*args, **kw):
        step = make(*args, **kw)

        def traced(*xs):
            calls.append(len(calls))
            if calls[-1] != 2:
                return step(*xs)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = step(*xs)
                torch.cuda.synchronize()
            by_name = {}
            kinds = dict.fromkeys(("gemm", "hand-written", "elementwise",
                                   "other"), 0.0)
            for ev in prof.events():
                if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
                    continue
                s = ev.device_time_total / 1e6
                name = ev.name[5:] if ev.name.startswith("void ") else ev.name
                by_name[name] = by_name.get(name, 0.0) + s
                kinds["hand-written" if name.startswith(ours) else "gemm"
                      if any(w in name.lower() for w in (
                          "gemm", "xmma", "cutlass", "sm90", "nvjet"))
                      else "elementwise" if "elementwise" in name
                      else "other"] += s
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
            split.update(step=2, kernel_s=sum(kinds.values()), kinds=kinds,
                         top=top)
            return out
        return traced

    train.make_train_step = make_traced
    rc = train.main(argv)
    print(json.dumps(split), flush=True)
    return rc


def c12_readings() -> int:
    """``python3 chip_smoke.py --c12-readings``: ``[c12]`` through the
    plain products (cuBLAS) and the trained rounds' wall time."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from repro_torch.device import fp32_strict
    fp32_strict()
    dev = torch.device("cuda")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    if (ROOT / "src/repro_torch/kernels/cohort_gemm.py").exists():
        c12_engines(dev, plain=True)
    c12_round_times(dev)
    return 0


def gemm_readings(src=None) -> int:
    """``python3 chip_smoke.py --gemm-readings [SRC]``: the cohort GEMM's
    readings through the package under SRC (by default this checkout's
    ``src``), so that this file times an older checkout's kernel in the
    same call: every product of a step for one client and for a cohort
    of 4 (``cohort_gemm_phase``), the trained rounds' wall time
    (``c12_round_times``), then under the profiler a trained paper
    round's device share (``round_profile``) and one step's device time
    alone and in the cohort through the kernel and through cuBLAS
    (``[c8]``).  No result line."""
    if src:
        sys.path.insert(0, str(Path(src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.device import fp32_strict
    fp32_strict()
    dev = torch.device("cuda")
    log(f"[readings] package {Path(repro_torch.__file__).parent}")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    cohort_gemm_phase(dev)
    c12_round_times(dev)
    round_profile(dev)
    c8_step_check(dev)
    return 0


C13_CHECK = dict(num_layers=2, num_experts=16, experts_per_token=2,
                 capacity_factor=1.25)
C13_BATCH = 4
C13_STEPS = 8
C13_NEAR_TIE = 1e-6


def c13_moe_fp32(dev) -> None:
    """ROADMAP C13: qwen3-moe at 2 layers, full width, 16 experts top-2
    at the reference's capacity factor 1.25, in fp32 on the card and on
    the CPU (the compute dtype set to fp32 for this phase, the path
    ``tests/test_torch_zoo.py`` holds against the reference): 4 rows of
    64 random tokens, 8 greedy tokens each.  Every MoE call's routes
    (top-2 experts a token), dropped assignments and the greedy tokens
    must be equal; where a route differs its CPU top-2 gap (the 2nd and
    3rd probability over the 2nd) is logged, a near-tie being one below
    1e-6."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_arch
    from repro_torch.models import moe, registry, transformer
    from repro_torch.serve import engine
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch("qwen3-moe-30b-a3b"), **C13_CHECK)
    dtype = transformer.COMPUTE_DTYPE
    apply_moe = moe.apply_moe
    calls = {"cpu": [], "card": []}
    side = ["cpu"]

    def recording(cfg_, p_, x_):
        t = x_.shape[0] * x_.shape[1]
        logits = F.linear(x_.reshape(t, -1), p_["router"].to(x_.dtype)
                          ).float()
        probs = torch.softmax(logits, -1)
        sel = torch.sort(probs, dim=-1, descending=True, stable=True
                         ).indices[:, :cfg_.experts_per_token]
        pos = moe._positions_in_expert(sel.reshape(-1), cfg_.num_experts)
        kept = pos < moe.moe_capacity(cfg_, t)
        calls[side[0]].append((sel.cpu(), kept.cpu(), probs.cpu()))
        return apply_moe(cfg_, p_, x_)

    transformer.COMPUTE_DTYPE = torch.float32
    moe.apply_moe = recording
    try:
        params = registry.init_params(torch.Generator(device=dev)
                                      .manual_seed(0), cfg)
        p_cpu = tree_to(params, "cpu")
        tokens = torch.randint(0, cfg.vocab_size, (C13_BATCH, 64),
                               generator=torch.Generator().manual_seed(1))
        toks_cpu, _ = engine.generate(cfg, p_cpu, {"tokens": tokens},
                                      C13_STEPS)
        side[0] = "card"
        toks_card, _ = engine.generate(cfg, params,
                                       {"tokens": tokens.to(dev)}, C13_STEPS)
    finally:
        transformer.COMPUTE_DTYPE = dtype
        moe.apply_moe = apply_moe
    k = cfg.experts_per_token
    moved = dropped = 0
    first = None
    for i, ((sc, kc, pc), (sd, kd, _)) in enumerate(zip(calls["cpu"],
                                                        calls["card"])):
        diff = (sc.sort(-1).values != sd.sort(-1).values).any(-1)
        moved += int(diff.sum())
        dropped += int((~kc).sum())
        if first is None and (bool(diff.any()) or not torch.equal(kc, kd)):
            srt = pc.sort(-1, descending=True).values
            gap = (srt[:, k - 1] - srt[:, k]) / srt[:, k - 1]
            first = (i, [float(g) for g in gap[diff]][:8],
                     int((kc != kd).sum()))
    same_tokens = torch.equal(toks_cpu, toks_card.cpu())
    # equal, or the first divergence sits on an fp32 near-tie of the
    # router (and everything after it may follow it)
    ok = (len(calls["cpu"]) == len(calls["card"]) > 0
          and (same_tokens if first is None
               else bool(first[1]) and max(first[1]) < C13_NEAR_TIE))
    log(f"[c13] qwen3-moe {cfg.num_layers} layers full width, "
        f"{cfg.num_experts} experts top-{k}, capacity factor "
        f"{cfg.capacity_factor}, fp32, B={C13_BATCH}, {C13_STEPS} greedy "
        f"tokens: {len(calls['card'])} MoE calls a side, assignments "
        f"dropped on the CPU {dropped}, tokens routed elsewhere on the "
        f"card {moved}, first differing call "
        f"{'none' if first is None else first} (call, top-{k} gaps of its "
        f"moved tokens, drops that differ); greedy tokens equal "
        f"{same_tokens}; {time.perf_counter() - t0:.1f}s "
        f"{'OK' if ok else 'FAIL'}")
    del params, p_cpu
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError("C13: qwen3-moe in fp32 on the card routes, "
                             "drops or decodes unlike the CPU")


def fl_sim_cli(args, out_path) -> tuple:
    """``python -m repro_torch.launch.fl_sim ARGS --out OUT_PATH`` from
    the checkout: (seconds, stdout lines, the JSON it wrote); the rows
    of every scheme carry the reference's keys in order."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fl_sim", *args, "--out",
         str(out_path)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in lines:
        log(f"[cli] {line}")
    if proc.returncode != 0:
        log(proc.stderr[-4000:])
        raise AssertionError(f"fl_sim {args} exited {proc.returncode}")
    results = json.loads(Path(out_path).read_text())
    if not results or any(not rows or any(list(r) != ROW_KEYS for r in rows)
                          for rows in results.values()):
        raise AssertionError(f"fl_sim {args} wrote rows without the "
                             f"reference's keys")
    return secs, lines, results


def paper_clis() -> None:
    """The CLI with ``--out``: the fast profile, every scheme, 1 round;
    then ``--paper-profile --scheme dcs --rounds 1``, whose launch line
    must read ``probe_fuzzy`` 1 and ``neighbor_elect`` 1 and whose row's
    comm columns == ``comm_columns``."""
    import tempfile
    from repro_torch.launch.fl_sim import paper_config
    with tempfile.TemporaryDirectory() as tmp:
        fast_s, _, fast = fl_sim_cli(
            ["--scheme", "all", "--rounds", "1"], Path(tmp) / "fl.json")
        paper_s, lines, paper = fl_sim_cli(
            ["--paper-profile", "--scheme", "dcs", "--rounds", "1"],
            Path(tmp) / "paper.json")
        left = sorted(os.listdir(tmp))
    launches = prefix_launches(json.loads(next(line for line in lines
                               if line.startswith("[fl_sim] launches "))
                          .split("launches ", 1)[1]))
    row = paper["dcs"][0]
    cols = comm_columns(paper_config("dcs"), 30, row["n_selected"])
    ok = (sorted(fast) == sorted(OVERHEAD_KEYS) and list(paper) == ["dcs"]
          and all(row[k] == v for k, v in cols.items())
          and launches == {k: int(k in ("probe_fuzzy", "neighbor_elect"))
                           for k in launches}
          and left == ["fl.json", "paper.json"])
    log(f"[check] fl_sim --out: --scheme all --rounds 1 ({fast_s:.1f}s) "
        f"wrote {sorted(fast)} with the reference's keys; --paper-profile "
        f"--scheme dcs --rounds 1 ({paper_s:.1f}s): launches {launches}, "
        f"comm columns == core/overhead.py, files left {left} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("fl_sim --out is wrong")


# [protocols]: the state gather's width and the DCS exchange's fixed
# window (the other window is the one the road's block edges need)
PROTOCOL_STATE_DIM = 25
PROTOCOL_WINDOW = 64


def edge_window(pos, k: int, comm_range: float) -> int:
    """The most vehicles of a neighbouring block (the ring's, K blocks
    of the sorted positions ``pos``) that one vehicle has in range: the
    DCS exchange's window at which it is the dense election."""
    import torch
    from repro_torch.kernels.ref import _f32
    blk, most = pos.shape[0] // k, 0
    cr = _f32(comm_range, pos)
    block = lambda b: pos[(b % k) * blk:(b % k + 1) * blk]
    for b in range(k):
        for nb in (b - 1, b + 1):
            near = torch.abs(block(b)[:, None] - block(nb)[None, :]) <= cr
            most = max(most, int(near.sum(dim=1).max()))
    return most


def emulated_exchange(pos, evals, k: int, window: int, **kw):
    """The reference's DCS neighbour exchange emulated in one process:
    block b elects against its left neighbour's last ``window`` vehicles,
    itself and its right neighbour's first ``window`` (the ring wraps)."""
    import torch
    from repro_torch.core.protocol import _elect_block
    n = pos.shape[0]
    blk = n // k
    idx = torch.arange(n, dtype=torch.int32, device=pos.device)
    out = []
    for b in range(k):
        part = lambda z, c: z[(c % k) * blk:(c % k + 1) * blk]
        cand = [torch.cat([part(z, b - 1)[-window:], part(z, b),
                           part(z, b + 1)[:window]])
                for z in (pos, evals, idx)]
        out.append(_elect_block(part(pos, b), part(evals, b), part(idx, b),
                                *cand, **kw))
    return torch.cat(out)


def protocol_checks(mesh, sim, out) -> dict:
    """``[protocols]``, on one rank of the large fleet's 4-way mesh: the
    paper's three selection protocols (``core/protocol.py``) over round
    0's positions sorted along the road, their evaluations and their
    Eq. 8-normalized features (the fleet's, gathered from every rank's
    shard), each rank holding one block of the road.  The fuzzy gather
    against a stable top-n on one device; the state gather (the features
    and ``PROTOCOL_STATE_DIM`` - 4 seeded columns) against one device's
    ``fuzzy_eval`` kernel and top-n; the DCS exchange at the window the
    block edges need against the dense ``neighbor_elect`` kernel, and at
    ``PROTOCOL_WINDOW`` against ``emulated_exchange``.  Each check's
    result, its collective output bytes on this rank and their formula
    (N x state_dim x 4, N x 4, 6 W x 4)."""
    import torch
    from repro_torch.core import protocol
    from repro_torch.core.selection import ccs_fuzzy_select
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import all_gather
    dev, n, k, cfg = mesh.device, sim.n, mesh.size, sim.stage_cfg
    n_top = cfg.n_clients_central

    def fleet(key):
        return all_gather(mesh, torch.as_tensor(out[key], device=dev))[:n]
    pos, evals, feats = fleet("pos0"), fleet("evals0"), fleet("feats0")
    order = torch.argsort(pos, stable=True)
    pos, evals = pos[order].contiguous(), evals[order].contiguous()
    filler = torch.rand((n, PROTOCOL_STATE_DIM - 4),
                        generator=torch.Generator().manual_seed(25))
    states = torch.cat([sim.evaluator.normalize(
        feats[order], feats.max(dim=0).values), filler.to(dev)], 1)
    mine = lambda z: protocol.shard(z, mesh)

    def sent(fn):
        before = dict(mesh.collective_bytes)
        got = fn()
        return got, sum(v - before[key]
                        for key, v in mesh.collective_bytes.items())

    res = {}
    got, b = sent(lambda: protocol.make_ccs_fuzzy_gather(mesh, n_top)(
        mine(evals)))
    res["fuzzy gather"] = [bool(torch.equal(
        got, mine(ccs_fuzzy_select(evals, n_top)))), b, n * 4]
    got, b = sent(lambda: protocol.make_ccs_state_gather(
        mesh, sim.evaluator, n_top, PROTOCOL_STATE_DIM)(mine(states)))
    want = ccs_fuzzy_select(sim.evaluator.evaluate(
        states[:, :4].contiguous()), n_top)
    res[f"state gather (state_dim {PROTOCOL_STATE_DIM})"] = [
        bool(torch.equal(got, mine(want))), b, n * PROTOCOL_STATE_DIM * 4]
    kw = dict(comm_range=cfg.comm_range_m, top_m=cfg.top_m, e_tau=cfg.e_tau)
    dense = ops.neighbor_elect(pos, evals, **kw)
    w = edge_window(pos, k, cfg.comm_range_m)
    got, b = sent(lambda: protocol.make_dcs_neighbor_exchange(
        mesh, window=w, **kw)(mine(pos), mine(evals)))
    res[f"dcs exchange W={w} (the edges' most in range) vs dense"] = [
        bool(torch.equal(got, mine(dense))), b, 6 * w * 4]
    emu = emulated_exchange(pos, evals, k, PROTOCOL_WINDOW, **kw)
    got, b = sent(lambda: protocol.make_dcs_neighbor_exchange(
        mesh, window=PROTOCOL_WINDOW, **kw)(mine(pos), mine(evals)))
    res[f"dcs exchange W={PROTOCOL_WINDOW} vs the emulation (differs from "
        f"dense at {int((emu != dense).sum())} vehicles)"] = [
        bool(torch.equal(got, mine(emu))), b, 6 * PROTOCOL_WINDOW * 4]
    return res


def large_fleet_rank(mesh, cfg, run, event_run=None):
    """One rank of the large fleet's 4-way mesh: round 0 with the launch
    counts reset just before and read just after, then the selection
    protocols on round 0's fleet (``protocol_checks``), then
    ``probe_loss`` timed on the rank's region while the other ranks time
    theirs; with ``event_run``, then ``LARGE_EVENT_ROUNDS`` rounds of the
    event server under it from the same initial params (``event/...``
    keys)."""
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.kernels import ops
    from repro_torch.launch import fl_sim
    sim = FLSimulation(cfg, run=run, mesh=mesh)
    params0 = {k: v.clone() for k, v in sim.params.items()}
    out = fl_sim.drive_rounds(sim, 1)
    t0 = time.perf_counter()
    out["protocols"] = protocol_checks(mesh, sim, out)
    out["protocols_s"] = time.perf_counter() - t0
    if event_run is not None:
        ev = with_run(sim, event_run)
        ev.params = params0
        out.update({f"event/{k}": v for k, v in
                    event_rounds(ev, LARGE_EVENT_ROUNDS).items()})
    st = sim.statics
    probe = (sim.params, st.probe_images, st.probe_labels, st.probe_seg,
             st.probe_counts)
    out["probe_loss_ms"] = time_ms(
        lambda: ops.probe_loss(*probe, n_clients=sim.n), 5)
    out["region_rows"] = int(st.probe_images.shape[0])
    return out


def mesh_large_fleet(dev, big0, big):
    """The large fleet on 4 ranks of the one card for round 0 through
    ``elect="auto"`` (the ring halo: one hop, 2h + 1 = 3 <= 4).  Each
    rank launches ``probe_loss``, ``fuzzy_eval`` and ``windowed_counts``
    once and ``probe_fuzzy`` never; unless a rank flags overflow, the
    round's masks and the ranks' evals equal phase 5's single-device
    round 0 bit for bit (an overflowed round re-runs through the gather
    seam, whose masks are the dense election's too).  Then, on the same
    ranks, ``[mesh event]``'s large fleet: ``LARGE_EVENT_ROUNDS`` rounds
    of the event server at churn 0.2 against the same rounds on one
    device (``big`` under that run, from the initial weights;
    ``compare_event``).  Returns the round-0 launches summed over the
    ranks."""
    import numpy as np
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.perf_counter()
    event_run = RunConfig(mesh="clients=4", overlap_rounds=False,
                          churn_rate=EVENT_RUN["churn_rate"])
    ranks = spawn_ranks(large_fleet_rank, 4, dev.type, args=(
        large_fleet_config("uniform"), RunConfig(mesh="clients=4"),
        event_run))
    spawn_s = time.perf_counter() - t0
    n = big0["mask"].shape[0]
    evals = np.concatenate([r["evals0"] for r in ranks])[:n]
    flags = [r["overflow0"] for r in ranks]
    masks = all(bool((r["mask0"] == big0["mask"].numpy()).all())
                for r in ranks)
    same_evals = bool((evals == big0["evals"].numpy()).all())
    for r, res in enumerate(ranks):
        log(f"[mesh large fleet] rank {r}: region S={res['region_rows']}, "
            f"launches {json.dumps(res['launches'])}, probe_loss "
            f"{res['probe_loss_ms']:.4f} ms (4 ranks share the card), "
            f"prefix {res['prefix_s'][0]:.4f} s, round {res['round_s'][0]:.4f}"
            f" s, host-staged {json.dumps(res['staged'])}")
    over = max(flags)
    want = ({"probe_loss": 1, "fuzzy_eval": 1, "windowed_counts": 1}
            if not over else
            {"probe_loss": 2, "fuzzy_eval": 2, "windowed_counts": 1,
             "neighbor_elect": 1})
    launch_ok = all(prefix_launches(r["launches"]) == {
        k: want.get(k, 0) for k in prefix_launches(r["launches"])}
        for r in ranks)
    for r, res in enumerate(ranks):
        log(f"[protocols] rank {r} of 4, N={n} ({res['protocols_s']:.2f} "
            f"s): " + "; ".join(
                f"{name}: {'equal' if same else 'DIFFERS'}, {b} bytes "
                f"(formula {want})" for name, (same, b, want)
                in res["protocols"].items()))
    protocols_ok = all(same and b == want for res in ranks
                       for same, b, want in res["protocols"].values())
    log(f"[check] protocols on 4 ranks at N={n}: every mask as expected and "
        f"every rank's bytes equal to their formula {protocols_ok} "
        f"{'OK' if protocols_ok else 'FAIL'}")
    ok = masks and same_evals and launch_ok and ranks[0]["rows"][0][
        "n_selected"] > 0 and protocols_ok
    log(f"[check] mesh clients=4 large fleet round 0 ({spawn_s:.1f}s with "
        f"start-up): overflow flags {flags}, masks bit-equal to the "
        f"single-device round {masks}, evals bit-equal {same_evals}, "
        f"launches per rank as expected {launch_ok}; row "
        f"{json.dumps(ranks[0]['rows'][0])} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the 4-rank large fleet differs from one device")
    import torch
    from repro_torch.configs.mnist_cnn import CONFIG
    from repro_torch.models.cnn import init_cnn
    ev = with_run(big, dataclasses.replace(event_run, mesh=None))
    ev.params = init_cnn(torch.Generator().manual_seed(big.cfg.seed),
                         CONFIG, dev)
    single = event_rounds(ev, LARGE_EVENT_ROUNDS)
    compare_event("large fleet, churn 0.2", [
        {k[len("event/"):]: v for k, v in r.items()
         if k.startswith("event/")} for r in ranks], single,
        LARGE_EVENT_ROUNDS)
    return {k: sum(r["launches"][k] for r in ranks)
            for k in ranks[0]["launches"]}


# phase 5f: the multi-seed sweep (launch/sweep.py), its seeds a group
SWEEP_SEEDS = 4
SWEEP_FAST_ARGV = ["--fast", "--seeds", str(SWEEP_SEEDS), "--rounds", "2",
                   "--schemes", "all"]
# Table 3's partition (paper_cell_config) exhausts a class for every
# seed but 0, in the reference as in the port (ROADMAP C10): the paper
# profile's sweep runs seed 0, and 2 seeds must raise as the reference's
SWEEP_PAPER_ARGV = ["--paper-profile", "--seeds", "1", "--rounds", "1"]
SWEEP_PAPER_SEEDS_ARGV = ["--paper-profile", "--seeds", "2", "--rounds",
                          "1"]
# a scale of one seed's aux columns that Eq. 8 undoes exactly (a power
# of 2): that seed's evals must not move, and no other seed's may
EQ8_TRAP_SCALE = 1024.0


def sweep_kernels(dev, big, bfeats) -> dict:
    """Phase 5f's kernels: one ``dcs`` group of ``SWEEP_SEEDS`` fast-cell
    seeds (``fast_cell_config``), round 0.  The seed-batched
    ``probe_fuzzy`` and ``neighbor_elect`` against S single launches on
    the same seeds (feats, evals and masks bit-equal), against their
    plain seed versions (LF within 1e-5 of the largest loss, evals 1e-3
    on [0, 100], masks equal) and against themselves (bit-repeatable);
    one seed's aux scaled by ``EQ8_TRAP_SCALE`` moves no bit of any seed
    (Eq. 8 per seed, never over the union).  The seed-batched prefix
    against S single-seed prefixes on the same simulations: every output
    bit-equal.  Then CUDA-event times (batched against S singles, bounds
    scaled by S) and the prefix's wall time a round; then
    ``seed_axis_kernels`` on the same seeds and ``big``'s regions.
    Returns the readings and the calls phase 6 profiles."""
    import numpy as np
    import torch
    from repro_torch.core.rules import build_rule_table
    from repro_torch.fl import pipeline
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.sweep import fast_cell_config
    n_s = SWEEP_SEEDS
    sims = [FLSimulation(fast_cell_config("dcs", 9, "uniform", seed),
                         run=RunConfig(), device=dev) for seed in range(n_s)]
    cfg = sims[0].stage_cfg
    n = cfg.n_clients
    st = pipeline.stack_statics([s.statics for s in sims])
    fields = [s.round_fields(0) for s in sims]
    sf = pipeline.stack_fields(fields)
    params = {k: torch.stack([s.params[k] for s in sims])
              for k in sims[0].params}
    pos = pipeline.positions(st, cfg, torch.zeros((), device=dev))
    aux = pipeline.aux_features(st, cfg, pos, sf)
    table, levels = build_rule_table()
    mam = (st.means, st.sigmas, table, levels, st.level_centers)
    mam_ref = (st.means, st.sigmas, torch.as_tensor(table, device=dev),
               torch.as_tensor(levels, device=dev), st.level_centers)
    s_rows = st.probe_images.shape[1]
    log(f"[sweep kernels] {n_s} seeds of fast_cell_config('dcs', 9, "
        f"'uniform'): probe S={s_rows} a seed, N={n}")

    def batched_probe(a=aux):
        return ops.probe_fuzzy(params, st.probe_images, st.probe_labels,
                               st.probe_seg, st.probe_counts, a, *mam,
                               n_clients=n)

    def single_probe(i, a=aux):
        si = sims[i].statics
        return ops.probe_fuzzy(sims[i].params, si.probe_images,
                               si.probe_labels, si.probe_seg,
                               si.probe_counts, a[i].contiguous(), *mam,
                               n_clients=n)

    def single_probes():
        return [single_probe(i) for i in range(n_s)]

    f, e = batched_probe()
    f2, e2 = batched_probe()
    singles = single_probes()
    f0, e0 = ref.probe_fuzzy_ref(
        params, st.probe_images, st.probe_labels, st.probe_seg,
        st.probe_counts, aux, *mam_ref, n_clients=n)
    scaled = aux.clone()
    scaled[1] *= EQ8_TRAP_SCALE
    ft, et = batched_probe(scaled)
    ft1, et1 = single_probe(1, scaled)
    torch.cuda.synchronize()
    bit = all(torch.equal(f[i], fi) and torch.equal(e[i], ei)
              for i, (fi, ei) in enumerate(singles))
    rep = torch.equal(f, f2) and torch.equal(e, e2)
    lf_err = float((f[..., 3] - f0[..., 3]).abs().max()
                   / f0[..., 3].abs().max())
    ev_err = float((e - e0).abs().max())
    trap = (torch.equal(et, e) and torch.equal(ft1, ft[1])
            and torch.equal(et1, et[1])
            and torch.equal(ft[[0, 2, 3]], f[[0, 2, 3]]))
    ok = (bit and rep and lf_err <= 1e-5 and ev_err <= 1e-3 and trap
          and torch.equal(f[..., :3], f0[..., :3])
          and bool(torch.isfinite(e).all()))
    log(f"[check] probe_fuzzy seeds S={n_s}: bit-equal to {n_s} single "
        f"launches {bit}, bit-repeatable {rep}; against the plain seed "
        f"version LF max err / scale {lf_err:.3g} (tol 1e-5), eval max "
        f"abs err {ev_err:.3g} (tol 1e-3 on [0, 100]); seed 1's aux x "
        f"{EQ8_TRAP_SCALE:g}: every seed's evals unchanged and seed 1 "
        f"equal to its single launch {trap} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the seed-batched probe_fuzzy is wrong")

    kw = dict(comm_range=cfg.comm_range_m, top_m=cfg.top_m, e_tau=cfg.e_tau)
    ev_tie = e.clone()
    ev_tie[:, 1::3] = ev_tie[:, 0::3][:, :ev_tie[:, 1::3].shape[1]]
    for label, ev in (("round 0", e), ("tied evals", ev_tie)):
        got = ops.neighbor_elect(pos, ev, **kw)
        again = ops.neighbor_elect(pos, ev, **kw)
        one = [ops.neighbor_elect(pos[i].contiguous(), ev[i].contiguous(),
                                  **kw) for i in range(n_s)]
        want = ref.neighbor_elect_ref(pos, ev, **kw)
        torch.cuda.synchronize()
        ok = (torch.equal(got, want) and torch.equal(got, again)
              and all(torch.equal(got[i], m) for i, m in enumerate(one)))
        log(f"[check] neighbor_elect seeds S={n_s} N={n} {label}: bit-equal "
            f"to {n_s} single launches, the plain seed version and itself "
            f"{ok}; selected {got.sum(dim=1).tolist()} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the seed-batched neighbor_elect is wrong")

    def batched_prefix():
        stacked = {k: torch.stack([s.params[k] for s in sims])
                   for k in sims[0].params}
        return pipeline.selection_prefix_seeds(
            st, stacked, 0, pipeline.stack_fields(fields), cfg=cfg)

    def single_prefixes():
        return [s.selection_state(0, f) for s, f in zip(sims, fields)]

    outs, one = batched_prefix(), single_prefixes()
    torch.cuda.synchronize()
    same = all(torch.equal(outs[k][i], v) for i, o in enumerate(one)
               for k, v in o.items())
    log(f"[check] selection_prefix_seeds S={n_s}: every output bit-equal "
        f"to {n_s} single-seed prefixes {same} {'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the seed-batched prefix differs")

    # wall time of one round's prefix, host clock, synchronised, the
    # two forms in turns
    walls = {"batched": [], "singles": []}
    for _ in range(10):
        for name, fn in (("batched", batched_prefix),
                         ("singles", single_prefixes)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append(1e3 * (time.perf_counter() - t))
    med = {k: float(np.median(v)) for k, v in walls.items()}
    log(f"[time] selection prefix a round, {n_s} seeds (host clock, "
        f"synchronised, median of 10; min): seed-batched {med['batched']:.4f}"
        f" ms ({min(walls['batched']):.4f}), {n_s} single-seed prefixes "
        f"{med['singles']:.4f} ms ({min(walls['singles']):.4f}); ratio "
        f"{med['batched'] / med['singles']:.3f}")

    param_bytes = sum(t.numel() * 4 for t in sims[0].params.values())
    probe_b = probe_bounds(s_rows * (28 * 28 * 4 + 8) + n * 36 + param_bytes,
                           s_rows)[0]
    elect_b = bound(n * 12, n * n * ELECT_OPS_PER_PAIR)
    reading = {}
    for name, fn, single_fn, iters, (b_ms, b_by) in (
            ("probe_fuzzy", batched_probe, single_probes, 20, probe_b),
            ("neighbor_elect",
             lambda: ops.neighbor_elect(pos, e, **kw),
             lambda: [ops.neighbor_elect(pos[i], e[i], **kw)
                      for i in range(n_s)], 200, elect_b)):
        ms, single_ms = time_ms(fn, iters), time_ms(single_fn, iters)
        reading[name] = {"S": n_s, "ms": ms, f"single_x{n_s}_ms": single_ms,
                         "bound_ms": n_s * b_ms, "bound_by": b_by,
                         "calls": (fn, single_fn)}
        log(f"[time] {name} seeds S={n_s}: one seed-batched launch "
            f"{ms:.4f} ms, {n_s} single launches {single_ms:.4f} ms, "
            f"bound {n_s} x {b_ms:.3g} = {n_s * b_ms:.3g} ms ({b_by})")
    reading["prefix_ms"] = med
    reading.update(seed_axis_kernels(dev, st, params, n, f, big, bfeats))
    return reading


def sweep_cli(argv, out_path) -> tuple:
    """``launch/sweep.py``'s ``main(ARGV + ["--out", OUT_PATH])`` in this
    process, its launch counts reset just before and read just after:
    (seconds, launches, the CSV's text)."""
    from repro_torch.kernels import build
    from repro_torch.launch import sweep
    buf = io.StringIO()
    build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = sweep.main(list(argv) + ["--out", str(out_path)])
    secs = time.perf_counter() - t0
    launches = prefix_launches(dict(build.LAUNCHES))
    for line in buf.getvalue().strip().splitlines():
        log(f"[sweep cli] {line}")
    if rc != 0:
        raise AssertionError(f"sweep {argv} returned {rc}")
    return secs, launches, Path(out_path).read_text()


def check_sweep_csv(label: str, text: str, n_rows: int, cfg_fn) -> None:
    """The CSV has the reference's header, ``n_rows`` rows that re-emit
    byte for byte through ``parse_csv_rows`` and ``rows_to_csv``, sane
    counts, and comm columns that format as ``core/overhead.py``'s."""
    from repro_torch.launch import sweep
    rows = sweep.parse_csv_rows(text)
    ok = rows is not None and len(rows) == n_rows \
        and sweep.rows_to_csv(rows) == text
    for row in rows or ():
        cfg = cfg_fn(row["scheme"], row["classes_per_client"],
                     row["distribution"], row["seed"])
        cols = comm_columns(cfg, cfg.partition.n_clients, row["n_selected"])
        ok = ok and all(sweep._FMT[k].format(v)
                        == sweep._FMT[k].format(row[k])
                        for k, v in cols.items())
        # the event server aggregates late updates of earlier rounds too
        sync = not (row["churn_rate"] or row["staleness_lambda"]
                    or row["agg_cadence_s"])
        ok = ok and (0.0 <= row["accuracy"] <= 1.0
                     and math.isfinite(row["mean_eval_selected"])
                     and 0 <= row["n_aggregated"]
                     and (row["n_aggregated"] <= row["n_selected"]
                          or not sync)
                     and row["n_selected"] <= cfg.partition.n_clients
                     and row["n_active"] <= cfg.partition.n_clients)
    log(f"[check] sweep {label}: {n_rows} rows, the reference's header, "
        f"parse/format byte-stable, comm columns == core/overhead.py, "
        f"counts sane {ok} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"sweep {label}: bad CSV")


def sweep_phase(dev, big, bfeats) -> dict:
    """Phase 5f: ``sweep_kernels``, then the sweep through its CLI entry
    point (``main``), on the card: ``SWEEP_FAST_ARGV`` twice, with
    ``--no-vmap`` and with ``--workers 2`` (two spawned processes
    sharing the card; the four CSVs byte-equal; the batched runs in this
    process launch ``probe_fuzzy`` once a round a group and
    ``neighbor_elect`` once a round of the ``dcs`` group, nothing else;
    ``--no-vmap`` once a seed),
    then ``SWEEP_PAPER_ARGV`` (one ``probe_fuzzy`` a group, one
    ``neighbor_elect``; Table 3's comm columns) and
    ``SWEEP_PAPER_SEEDS_ARGV``, which raises the reference's partition
    error (C10); then ``mesh_sweep`` against the default run's CSV.
    Returns ``sweep_kernels``' readings with the batched fast run's
    launches and the mesh sweep's rank 0's (``mesh_launches``)."""
    import tempfile
    from repro_torch.launch.sweep import fast_cell_config, paper_cell_config
    reading = sweep_kernels(dev, big, bfeats)
    n_s, rounds, groups = SWEEP_SEEDS, 2, 3
    want = {"probe_fuzzy": groups * rounds, "neighbor_elect": rounds}
    with tempfile.TemporaryDirectory() as tmp:
        runs = {}
        for label, extra in (("default", []), ("default again", []),
                             ("--no-vmap", ["--no-vmap"]),
                             ("--workers 2", ["--workers", "2"])):
            runs[label] = sweep_cli(SWEEP_FAST_ARGV + extra,
                                    Path(tmp) / f"{len(runs)}.csv")
        paper_s, paper_launches, paper_csv = sweep_cli(
            SWEEP_PAPER_ARGV, Path(tmp) / "paper.csv")
        try:
            sweep_cli(SWEEP_PAPER_SEEDS_ARGV, Path(tmp) / "paper2.csv")
            c10 = "ran"
        except ValueError as err:
            c10 = str(err)
    texts = {label: r[2] for label, r in runs.items()}
    launches = {label: r[1] for label, r in runs.items()}
    check_sweep_csv("fast", texts["default"], groups * n_s * rounds,
                    fast_cell_config)
    check_sweep_csv("paper profile", paper_csv, groups,
                    paper_cell_config)
    same = len(set(texts.values())) == 1
    full = lambda w: {k: w.get(k, 0) for k in launches["default"]}
    ok = (same and all(launches[k] == full(want)
                       for k in ("default", "default again"))
          and launches["--no-vmap"] == full(
              {k: n_s * v for k, v in want.items()})
          and paper_launches == full({"probe_fuzzy": groups,
                                      "neighbor_elect": 1})
          and c10 == "class 7 exhausted for client 26: need 5, have 1")
    log(f"[check] sweep {' '.join(SWEEP_FAST_ARGV)}: CSVs of the default "
        f"run, a second default run, --no-vmap and --workers 2 byte-equal "
        f"{same}; "
        f"launches {launches['default']} (want {want}: one seed-batched "
        f"launch a round a group), --no-vmap {launches['--no-vmap']}; "
        + "; ".join(f"{k} {v[0]:.1f}s" for k, v in runs.items())
        + f"; {' '.join(SWEEP_PAPER_ARGV)} {paper_s:.1f}s, launches "
        f"{paper_launches}; {' '.join(SWEEP_PAPER_SEEDS_ARGV)}: {c10} (the "
        f"reference's partition error, C10) {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the sweep on the card is wrong")
    reading["launches"] = launches["default"]
    reading["mesh_launches"] = mesh_sweep(texts["default"])
    return reading


# phase 5g: the round drivers (fl/rounds.py::run_schedule, round-ahead
# by default; fl/async_server.py::EventDrivenServer) on the fast profile
# and the large fleet
DRIVER_ROUNDS = 4
# the event server's non-degenerate scenario: churn, weighted staleness,
# and a cadence of 1.5 round periods, so some updates land a round late
EVENT_RUN = dict(churn_rate=0.2, staleness="weighted", staleness_lambda=0.5)
EVENT_CADENCE_PERIODS = 1.5
# a landing tick may differ between the card and the CPU only where
# t_done / T is this close (relative) to an integer on one side
TICK_MARGIN = 1e-5
FL_SIM_EVENT_ARGS = ["--scheme", "all", "--rounds", "3", "--server", "event",
                     "--churn-rate", "0.2", "--staleness", "weighted",
                     "--staleness-lambda", "0.5"]
SWEEP_EVENT_ARGV = ["--fast", "--seeds", "2", "--rounds", "2", "--schemes",
                    "dcs", "--churn-rates", "0,0.2", "--staleness-lambdas",
                    "0,0.5"]


class SyncSites:
    """A ``run_schedule`` stretch that records, by call site, every
    synchronising CUDA call made in it (``torch.cuda.set_sync_debug_mode``
    "warn"); with ``error=True`` the first one raises instead."""

    def __init__(self, error: bool = False):
        self.error = error
        self.sites = {}

    @contextlib.contextmanager
    def __call__(self, r):
        import warnings
        import torch
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("error" if self.error else "warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(0)
        for w in caught:
            if "synchroniz" in str(w.message):
                path = Path(w.filename)
                if path.is_relative_to(ROOT):
                    path = path.relative_to(ROOT)
                site = f"{path}:{w.lineno}"
                self.sites[site] = self.sites.get(site, 0) + 1


def schedule_run(sim, params0, n_rounds: int, overlap: bool, stretch=None):
    """``n_rounds`` rounds of ``sim.driver()`` through ``run_schedule``
    from ``params0``, the launch counts reset just before: (rows, the
    final params, each round's wall seconds from the previous row to its
    own, each round's mask, the launches)."""
    import torch
    from repro_torch.fl.rounds import run_schedule
    from repro_torch.kernels import build
    sim.params = {k: v.clone() for k, v in params0.items()}
    times, masks = [], []
    build.reset_launches()
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def on_row(r, host, row):
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now
        masks.append(host["mask"].copy())

    rows = run_schedule(sim.driver(), sim, n_rounds, overlap=overlap,
                        stretch=stretch, on_row=on_row)
    torch.cuda.synchronize()
    return (rows, sim.params, times, masks,
            prefix_launches(dict(build.LAUNCHES)))


def same_params(a, b) -> bool:
    import torch
    return all(torch.equal(a[k], b[k]) for k in a)


def overlap_checks(dev, big) -> None:
    """The round-ahead schedule against the serial one: the fast profile
    for ``DRIVER_ROUNDS`` rounds, four runs alternating round-ahead
    (the first under ``set_sync_debug_mode("error")`` from each round's
    training dispatch through the next prefix's enqueue) and serial, rows
    and params bit-equal, the median round of rounds 1-3 of each as a
    reading; then the large fleet for 2 rounds each way (masks and rows
    equal), with the synchronising calls left on its stretch by site."""
    import numpy as np
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    sim = FLSimulation(fast_config_dcs(DRIVER_ROUNDS), run=RunConfig(),
                       device=dev)
    params0 = {k: v.clone() for k, v in sim.params.items()}
    runs = []
    fast_sites = SyncSites()
    for overlap, stretch in ((True, SyncSites(error=True)), (False, None),
                             (True, fast_sites), (False, None)):
        runs.append((overlap,) + schedule_run(sim, params0, DRIVER_ROUNDS,
                                              overlap, stretch))
    _, rows0, p0, _, _, launches0 = runs[0]
    same = all(r[1] == rows0 and same_params(r[2], p0) for r in runs[1:])
    want = {"probe_fuzzy": DRIVER_ROUNDS, "neighbor_elect": DRIVER_ROUNDS}
    launch_ok = all(r[5] == {k: want.get(k, 0) for k in r[5]} for r in runs)
    med = {o: float(np.median([t for r in runs if r[0] == o
                               for t in r[3][1:]])) for o in (True, False)}
    log("[round drivers] fast profile dcs, round wall s (host clock; "
        "from the previous row to the round's own) by run: " + "; ".join(
            f"{'round-ahead' if r[0] else 'serial'} "
            f"[{', '.join(f'{t:.4f}' for t in r[3])}]" for r in runs))
    log(f"[round drivers] fast profile median round of rounds 1-3: "
        f"round-ahead {med[True]:.4f} s, serial {med[False]:.4f} s (a "
        f"reading); synchronising calls on the round-ahead stretch "
        f"{fast_sites.sites or 'none'}")
    ok = same and launch_ok and not fast_sites.sites
    log(f"[check] round-ahead vs serial, fast profile, {DRIVER_ROUNDS} "
        f"rounds x 4 runs: rows and params bit-equal {same}; the stretch "
        f"from training dispatch to the next prefix's enqueue raised "
        f"nothing under set_sync_debug_mode('error'); launches a run "
        f"{launches0} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the round-ahead schedule differs on the card")

    # the large fleet, 2 rounds each way from the same params
    bparams0 = {k: v.clone() for k, v in big.params.items()}
    big_sites = SyncSites()
    ra = schedule_run(big, bparams0, 2, True, big_sites)
    se = schedule_run(big, bparams0, 2, False)
    same = (ra[0] == se[0] and all(np.array_equal(a, b)
                                   for a, b in zip(ra[3], se[3])))
    log(f"[round drivers] large fleet round wall s: round-ahead "
        f"[{', '.join(f'{t:.4f}' for t in ra[2])}] (sum {sum(ra[2]):.4f}),"
        f" serial [{', '.join(f'{t:.4f}' for t in se[2])}] (sum "
        f"{sum(se[2]):.4f}); synchronising calls "
        f"left on the round-ahead stretch (2 rounds), by site: "
        f"{json.dumps(big_sites.sites)}")
    ok = same and ra[4] == se[4] and ra[4]["windowed_counts"] == 2
    log(f"[check] round-ahead vs serial, large fleet, 2 rounds: masks and "
        f"rows equal {same}; launches {ra[4]} / {se[4]} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the large fleet's round-ahead rounds differ")


def event_checks(dev) -> tuple:
    """The event-driven server on the fast profile: the degenerate one
    (default knobs) bit-equal to the sync driver; then ``EVENT_RUN`` with
    a cadence of ``EVENT_CADENCE_PERIODS`` periods for
    ``DRIVER_ROUNDS`` rounds on the card against the port's CPU path in
    lockstep (each round starts the CPU from the card's global params;
    the draws are the same generators'): masks (C3's near-tie rule),
    ``n_active``, the landing ticks (equal unless ``t_done / T`` sits
    within ``TICK_MARGIN`` of an integer), ``n_aggregated``,
    ``rounds_behind_hist`` and ``stale_frac`` equal, ``n_effective``
    within 1e-9, accuracy within 0.01, one ``probe_fuzzy`` and one
    ``neighbor_elect`` launch a round, some round stale.  Returns round
    0's prefix (positions, churn-gated evals) for the kernel checks."""
    import numpy as np
    import torch
    from repro_torch.fl.async_server import EventDrivenServer
    from repro_torch.fl.client import evaluate_accuracy_async
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.kernels import build
    cfg = fast_config_dcs(DRIVER_ROUNDS)
    sync = FLSimulation(cfg, run=RunConfig(), device=dev)
    params0 = {k: v.clone() for k, v in sync.params.items()}
    event = FLSimulation(cfg, run=RunConfig(server="event"), device=dev)
    a = schedule_run(sync, params0, DRIVER_ROUNDS, True)
    b = schedule_run(event, params0, DRIVER_ROUNDS, True)
    same = (a[0] == b[0] and same_params(a[1], b[1])
            and EventDrivenServer(event).sync_equivalent)
    log(f"[check] degenerate event server (server='event', default knobs) "
        f"vs the sync driver, {DRIVER_ROUNDS} rounds: rows and params "
        f"bit-equal {same} {'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("the degenerate event server is not the sync "
                             "driver")

    run = RunConfig(**EVENT_RUN,
                    agg_cadence_s=EVENT_CADENCE_PERIODS * cfg.deadline_s)
    card = FLSimulation(cfg, run=run, device=dev)
    cpu = FLSimulation(cfg, run=run, device="cpu")
    srv = {"card": EventDrivenServer(card), "cpu": EventDrivenServer(cpu)}
    cadence = srv["card"].cadence
    rows, first, diverged, notes = [], None, False, []
    for r in range(DRIVER_ROUNDS):
        cpu.params = {k: v.cpu() for k, v in card.params.items()}
        fields = card.round_fields(r)
        hosts, got = {}, {}
        build.reset_launches()
        for name, sim in (("card", card), ("cpu", cpu)):
            hosts[name] = sim._host(sim.selection_state(r, fields))
            if name == "card":
                launches = prefix_launches(dict(build.LAUNCHES))
            srv[name]._dispatch_training(r, hosts[name], fields)
            acc, n_test = evaluate_accuracy_async(
                sim.params, sim.test_images, sim.test_labels, batch=256)
            got[name] = srv[name]._round_row(r, hosts[name], acc, n_test)
        hc, hp = hosts["card"], hosts["cpu"]
        if first is None:
            first = (torch.tensor(hc["pos"], device=dev),
                     torch.tensor(hc["evals"], device=dev))
        rows.append(got["card"])
        want = {k: int(k in ("probe_fuzzy", "neighbor_elect"))
                for k in launches}
        ev_err = float(np.abs(hc["evals"] - hp["evals"]).max())
        # departed clients tie at +0.0 and are never elected: the margin
        # is the active clients'
        margin = eval_margin(hp["evals"][hp["evals"] != 0], cfg.e_tau)
        if not np.array_equal(hc["mask"], hp["mask"]):
            if margin > 2 * ev_err:
                raise AssertionError(f"event round {r}: masks differ away "
                                     f"from a tie (margin {margin:.3g})")
            notes.append(f"round {r}: masks differ at a near-tie (margin "
                         f"{margin:.3g}); later rounds not compared")
            diverged = True
        if diverged:
            continue
        tc, tp = (srv["card"].landing_ticks(hc["t_done"]),
                  srv["cpu"].landing_ticks(hp["t_done"]))
        q = np.asarray(hp["t_done"], np.float64) / cadence
        rel = np.abs(q - np.round(q)) / np.abs(q)
        tick_margin = float(rel.min())
        near = rel <= TICK_MARGIN
        ticks_ok = bool(np.all((tc == tp) | near))
        c, p = got["card"], got["cpu"]
        ok = (ticks_ok and launches == want
              and int(hc["n_active"]) == int(hp["n_active"])
              and np.array_equal(hc["alive_at_done"], hp["alive_at_done"])
              and all(c[k] == p[k] for k in (
                  "n_selected", "n_aggregated", "n_straggler", "n_active",
                  "rounds_behind_hist", "stale_frac"))
              and abs(c["n_effective"] - p["n_effective"]) <= 1e-9
              and abs(c["accuracy"] - p["accuracy"]) <= 0.01)
        log(f"[event] round {r} card {json.dumps(c)}; cpu accuracy "
            f"{p['accuracy']:.4f}, eval max abs err {ev_err:.3g}, smallest "
            f"eval margin {margin:.3g}, smallest t_done/T distance to an "
            f"integer (relative) {tick_margin:.3g}, landing ticks equal "
            f"{bool(np.all(tc == tp))}, launches {launches} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"event server round {r}: the card and "
                                 f"the CPU disagree")
    stale = any(row["stale_frac"] > 0 for row in rows)
    active = any(row["n_active"] < card.n for row in rows)
    log(f"[check] event server churn {EVENT_RUN['churn_rate']}, weighted "
        f"lambda {EVENT_RUN['staleness_lambda']}, cadence {cadence} s, "
        f"{DRIVER_ROUNDS} rounds, card vs CPU in lockstep: some round stale "
        f"{stale}, churn seen {active}"
        + (f"; {'; '.join(notes)}" if notes else "")
        + f" {'OK' if stale and active else 'FAIL'}")
    if not (stale and active):
        raise AssertionError("the event scenario never went stale or "
                             "churned")
    return first


def churn_kernel_checks(dev, first, bpos0, bevals0, big_cfg,
                        window_big) -> None:
    """The kernels of the path on churn-gated evaluations (departed
    clients at +0.0, many exact ties below E_tau): ``neighbor_elect`` at
    the event scenario's round 0 (N = 30) and ``windowed_counts`` at the
    large fleet's round 0 gated at churn 0.2, each bit-equal to its plain
    version; the windowed election's mask equals the dense kernel's
    wherever its flag is 0."""
    import torch
    from repro_torch.fl.mobility import coverage_active
    from repro_torch.kernels import ops, ref
    pos, ev = first
    kw = dict(comm_range=big_cfg.comm_range_m, top_m=big_cfg.top_m,
              e_tau=big_cfg.e_tau)
    got = ops.neighbor_elect(pos, ev, **kw)
    same_dense = torch.equal(got, ref.neighbor_elect_ref(pos, ev, **kw))
    active = coverage_active(bpos0, road_length_m=big_cfg.road_length_m,
                             churn_rate=EVENT_RUN["churn_rate"])
    bev = torch.where(active, bevals0, torch.zeros_like(bevals0))
    from repro_torch.core.elect import SENT_EV, SENT_POS
    m = bpos0.shape[0]
    order = torch.argsort(bpos0, stable=True)
    pad = -(-m // 128) * 128 - m             # the election's sentinels
    sp = torch.cat([bpos0[order], torch.full((pad,), SENT_POS, device=dev)])
    se = torch.cat([bev[order], torch.full((pad,), SENT_EV, device=dev)])
    sg = torch.cat([order.to(torch.int32),
                    torch.full((pad,), m, dtype=torch.int32, device=dev)])
    wkw = dict(comm_range=big_cfg.comm_range_m, e_tau=big_cfg.e_tau,
               n_valid=m, window=window_big, block=128)
    same_counts = torch.equal(ops.windowed_counts(sp, se, sg, **wkw),
                              ref.windowed_counts_ref(sp, se, sg, **wkw))
    mask, ovf = ops.neighbor_elect_windowed(bpos0, bev, window=window_big,
                                            **kw)
    dense = ops.neighbor_elect(bpos0, bev, **kw)
    same_win = int(ovf) == 1 or torch.equal(mask, dense)
    ok = same_dense and same_counts and same_win
    log(f"[check] churn-gated inputs: neighbor_elect N={pos.shape[0]} "
        f"({int((ev == 0).sum())} evals at +0.0) bit-equal {same_dense}; "
        f"windowed_counts M={bpos0.shape[0]} window {window_big} "
        f"({int((~active).sum())} departed) bit-equal {same_counts}; "
        f"windowed election flag {int(ovf)}, mask equals dense "
        f"{torch.equal(mask, dense)} {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("a kernel disagrees on churn-gated evals")


def driver_clis() -> None:
    """``fl_sim`` with the event server for every scheme (``--out``:
    rc 0, 3 rows a scheme with the reference's keys, the server's
    banner), then the sweep over churn x lambda four times (default,
    ``--no-vmap``, ``--no-overlap-rounds``, default again): the CSVs
    byte-equal; one ``probe_fuzzy`` and one ``neighbor_elect`` launch a
    round a group for both seeds (one a seed with ``--no-vmap``)."""
    import tempfile
    from repro_torch.launch.sweep import fast_cell_config
    with tempfile.TemporaryDirectory() as tmp:
        secs, lines, res = fl_sim_cli(FL_SIM_EVENT_ARGS,
                                      Path(tmp) / "event.json")
        banner = any(line.startswith("[fl_sim] event-driven server: churn"
                                     "=0.2 staleness=weighted lam=0.5")
                     for line in lines)
        ok = (banner and sorted(res) == sorted(OVERHEAD_KEYS)
              and all(len(rows) == 3 for rows in res.values()))
        log(f"[check] fl_sim {' '.join(FL_SIM_EVENT_ARGS)} ({secs:.1f}s): "
            f"banner {banner}, rows a scheme "
            f"{ {k: len(v) for k, v in res.items()} } "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("fl_sim with the event server is wrong")
        runs = {}
        for label, extra in (("default", []), ("--no-vmap", ["--no-vmap"]),
                             ("--no-overlap-rounds", ["--no-overlap-rounds"]),
                             ("default again", [])):
            runs[label] = sweep_cli(SWEEP_EVENT_ARGV + extra,
                                    Path(tmp) / f"event{len(runs)}.csv")
    texts = {label: r[2] for label, r in runs.items()}
    scenarios, rounds, seeds = 4, 2, 2
    check_sweep_csv("scenarios", texts["default"], scenarios * rounds * seeds,
                    fast_cell_config)
    want = {"probe_fuzzy": scenarios * rounds,
            "neighbor_elect": scenarios * rounds}
    full = lambda w: {k: w.get(k, 0) for k in runs["default"][1]}
    launches_ok = all(
        runs[k][1] == full({n: v * (seeds if k == "--no-vmap" else 1)
                            for n, v in want.items()}) for k in runs)
    same = len(set(texts.values())) == 1
    ok = same and launches_ok
    log(f"[check] sweep {' '.join(SWEEP_EVENT_ARGV)}: default, --no-vmap, "
        f"--no-overlap-rounds and default again byte-equal {same}; launches "
        + "; ".join(f"{k} {v[1]} ({v[0]:.1f}s)" for k, v in runs.items())
        + f" {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the scenario sweep is wrong on the card")


def round_drivers(dev, big, bpos0, bevals0, window_big) -> None:
    """Phase 5g (``overlap_checks``, ``event_checks``,
    ``churn_kernel_checks``, ``driver_clis``)."""
    t0 = time.perf_counter()
    overlap_checks(dev, big)
    first = event_checks(dev)
    churn_kernel_checks(dev, first, bpos0, bevals0, big.stage_cfg,
                        window_big)
    driver_clis()
    log(f"[round drivers] phase 5g in {time.perf_counter() - t0:.1f}s")


# phase 5h: preemption on the card (train/checkpoint.py, the drivers'
# capture_state / restore_state, launch/faults.py).  Every kill is a
# SIGKILL in a child process started with REPRO_FAULTS; every resume
# runs in a fresh child process.  The children of a wave run together
# on the card (each on its own data: nothing they compute depends on
# the others), the readings in this process while no child runs.
PREEMPT_ROUNDS = 4
PREEMPT_SWEEP_ARGV = ["--fast", "--seeds", "4", "--rounds", "2", "--schemes",
                      "dcs,random"]
PREEMPT_CHILD_TIMEOUT_S = 300
# a byte of the newest round-ahead snapshot's payload, flipped
TORN_OFFSET = 4096


def preempt_config(profile: str):
    """The cell's ``FLSimConfig`` and ``RunConfig`` (no checkpoint
    knobs: the drivers get their checkpointer explicitly)."""
    from repro_torch.fl.runconfig import RunConfig
    if profile == "large":
        return large_fleet_config("uniform"), RunConfig()
    cfg = fast_config_dcs(PREEMPT_ROUNDS)
    if profile == "event":
        return cfg, RunConfig(**EVENT_RUN, agg_cadence_s=(
            EVENT_CADENCE_PERIODS * cfg.deadline_s))
    return cfg, RunConfig()


def params_digest(params) -> str:
    import hashlib
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(params[k].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def resumable_run(driver, sim, n_rounds: int, overlap: bool, ckpt,
                  resume: bool) -> dict:
    """``rounds.run_resumable`` with ``ckpt``, the launch counts reset
    just before: rows, the first round run here, the masks of the
    rounds run here, the params' digest, the launches."""
    import torch
    from repro_torch.fl.rounds import run_resumable
    from repro_torch.kernels import build
    masks = {}
    build.reset_launches()
    rows = run_resumable(driver, sim, n_rounds, overlap=overlap,
                         checkpointer=ckpt, resume=resume,
                         on_row=lambda r, host, row: masks.__setitem__(
                             str(r), host["mask"].tolist()))
    torch.cuda.synchronize()
    return {"rows": rows, "start": len(rows) - len(masks), "masks": masks,
            "params": params_digest(sim.params),
            "launches": dict(build.LAUNCHES)}


def preempt_child(spec_path: str) -> int:
    """``python3 chip_smoke.py --preempt-child SPEC``: one phase-5h cell
    in a fresh process on the card.  SPEC (JSON) names the profile
    (``fast``, ``large`` or ``event``), the rounds, the schedule and the
    runs, each a snapshot directory, whether to resume from it and a
    behaviour switch to set first (``overflow@resume``); a kill plan
    comes in the environment.  Each run's ``resumable_run`` result goes
    to the spec's ``out`` as JSON."""
    import torch
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.launch import faults
    from repro_torch.train.checkpoint import RoundCheckpointer
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    spec = json.loads(Path(spec_path).read_text())
    cfg, run = preempt_config(spec["profile"])
    sim = FLSimulation(cfg, run=run, device="cuda")
    out = []
    for step in spec["runs"]:
        if step.get("switch"):
            os.environ[faults.ENV_VAR] = step["switch"]
        out.append(resumable_run(sim.driver(), sim, spec["rounds"],
                                 spec["overlap"],
                                 RoundCheckpointer(step["dir"]),
                                 step["resume"]))
    Path(spec["out"]).write_text(json.dumps(out))
    return 0


class Children:
    """Child processes of one wave, started together, each logging to
    its own file; ``wait`` joins them under one deadline and kills every
    one still running when it passes (or when this process leaves the
    block), so no child outlives the phase."""

    def __init__(self, workdir: Path):
        self.workdir = workdir
        self.procs = {}

    def start(self, name: str, argv, plan=None) -> None:
        from repro_torch.launch import faults
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop(faults.ENV_VAR, None)
        if plan:
            env[faults.ENV_VAR] = plan
        logf = open(self.workdir / f"{name}.log", "w")
        self.procs[name] = (subprocess.Popen(
            [sys.executable, *argv], cwd=ROOT, env=env, stdout=logf,
            stderr=subprocess.STDOUT), logf)

    def child(self, name: str, spec: dict, plan=None) -> None:
        path = self.workdir / f"{name}.spec.json"
        path.write_text(json.dumps(dict(
            spec, out=str(self.workdir / f"{name}.out.json"))))
        self.start(name, [str(ROOT / "chip_smoke.py"), "--preempt-child",
                          str(path)], plan)

    def wait(self) -> dict:
        """{name: (exit code, log text, the child's JSON or None)}."""
        deadline = time.monotonic() + PREEMPT_CHILD_TIMEOUT_S
        try:
            for name, (proc, _) in self.procs.items():
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            self.stop()
        res = {}
        for name, (proc, _) in self.procs.items():
            out = self.workdir / f"{name}.out.json"
            res[name] = (proc.returncode,
                         (self.workdir / f"{name}.log").read_text(),
                         json.loads(out.read_text()) if out.exists()
                         else None)
        self.procs = {}
        return res

    def stop(self) -> None:
        for proc, logf in self.procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            logf.close()


def snapshot_cost(label: str, capture, ckdir: Path, rounds: int = 3) -> None:
    """Bytes of one snapshot and the seconds of capture + write + fsync
    (``capture()`` then ``RoundCheckpointer.save_round``, synchronised
    before), ``rounds`` times: a reading."""
    import torch
    from repro_torch.train.checkpoint import RoundCheckpointer
    ck = RoundCheckpointer(str(ckdir), keep=1)
    secs = []
    for r in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ck.save_round(r, capture(), extra={"rows": [], "next_round": r + 1})
        secs.append(time.perf_counter() - t0)
    size = sum(f.stat().st_size for f in Path(ck.path_for(rounds - 1))
               .iterdir())
    ck.clear()
    log(f"[preempt] snapshot {label}: {size} bytes; capture + write + "
        f"fsync s [{', '.join(f'{s:.4f}' for s in secs)}]")


def c4_determinism(dev) -> None:
    """ROADMAP C4: the trained rounds of the fast profile (4 rounds) and
    the paper profile (2 rounds) under the default algorithms and under
    ``torch.use_deterministic_algorithms(True)`` + ``cudnn.deterministic``,
    in turns (default, deterministic, deterministic, default) from the
    same params: each mode's median trained round (host clock, row to
    row) and whether its two runs repeat bit for bit (rows and params).
    Resume parity below runs with the defaults, so they must repeat."""
    import numpy as np
    import torch
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.launch.fl_sim import paper_config
    repeat_default = True
    for label, cfg, n in (("fast", fast_config_dcs(PREEMPT_ROUNDS),
                           PREEMPT_ROUNDS),
                          ("paper", paper_config("dcs"), 2)):
        sim = FLSimulation(cfg, run=RunConfig(), device=dev)
        params0 = {k: v.clone() for k, v in sim.params.items()}
        runs = {False: [], True: []}
        for det in (False, True, True, False):
            torch.use_deterministic_algorithms(det)
            torch.backends.cudnn.deterministic = det
            try:
                runs[det].append(schedule_run(sim, params0, n, True))
            finally:
                torch.use_deterministic_algorithms(False)
                torch.backends.cudnn.deterministic = False
        parts = []
        for det, (a, b) in runs.items():
            same = a[0] == b[0] and same_params(a[1], b[1])
            trained = [t for run in (a, b) for row, t in zip(run[0], run[2])
                       if row["n_aggregated"] > 0]
            parts.append(
                f"{'deterministic' if det else 'default'}: trained rounds "
                f"{len(trained)}, median {float(np.median(trained)):.4f} s "
                f"(all rounds [{', '.join(f'{t:.4f}' for t in a[2])}] / "
                f"[{', '.join(f'{t:.4f}' for t in b[2])}]), repeat bit for "
                f"bit {same}")
            if not det:
                repeat_default &= same
        same_modes = (runs[False][0][0] == runs[True][0][0]
                      and same_params(runs[False][0][1], runs[True][0][1]))
        log(f"[c4] {label} profile, {n} rounds x 2 a mode: "
            + "; ".join(parts) + f"; the two modes bit-equal {same_modes}")
        del sim
    log(f"[check] C4: the default algorithms repeat bit for bit "
        f"{repeat_default} {'OK' if repeat_default else 'FAIL'}")
    if not repeat_default:
        raise AssertionError("rounds do not repeat under the default "
                             "algorithms: resume parity cannot hold")


def checkpoint_round_times(dev, ckdir: Path) -> None:
    """The fast profile's median round of rounds 1-3 with a snapshot
    every round and without, in turns (without, with, with, without)
    from the same params: a reading."""
    import numpy as np
    import torch
    from repro_torch.fl.rounds import FLSimulation, run_schedule
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.train.checkpoint import RoundCheckpointer
    sim = FLSimulation(fast_config_dcs(PREEMPT_ROUNDS), run=RunConfig(),
                       device=dev)
    params0 = {k: v.clone() for k, v in sim.params.items()}
    times = {False: [], True: []}
    for with_ck in (False, True, True, False):
        ck = RoundCheckpointer(str(ckdir)) if with_ck else None
        sim.params = {k: v.clone() for k, v in params0.items()}
        stamps = []
        torch.cuda.synchronize()
        last = [time.perf_counter()]

        def on_row(r, host, row):
            now = time.perf_counter()
            stamps.append(now - last[0])
            last[0] = now
        run_schedule(sim, sim, PREEMPT_ROUNDS, overlap=True, on_row=on_row,
                     checkpointer=ck)
        torch.cuda.synchronize()
        # a round's snapshot lands between its row and the next row
        times[with_ck] += stamps[1:]
        if ck is not None:
            ck.clear()
    log(f"[preempt] fast profile median round of rounds 1-3 (host clock, "
        f"row to row, 2 runs each): with --checkpoint-every 1 "
        f"{float(np.median(times[True])):.4f} s "
        f"[{', '.join(f'{t:.4f}' for t in times[True])}], without "
        f"{float(np.median(times[False])):.4f} s "
        f"[{', '.join(f'{t:.4f}' for t in times[False])}] (a reading)")


def check_kill(name: str, res, event: str) -> None:
    rc, text, _ = res[name]
    ok = (rc == -9 and f"injecting sigkill at {event}" in text)
    log(f"[check] preempt {name}: SIGKILL at {event}: exit {rc} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        log(text[-4000:])
        raise AssertionError(f"{name}: the planned SIGKILL did not end it")


def check_resume(name: str, res, want_rows, want_params, start: int,
                 want_masks=None, run: int = 0) -> dict:
    rc, text, out = res[name]
    if rc != 0 or out is None:
        log(text[-4000:])
        raise AssertionError(f"{name}: the resume exited {rc}")
    got = out[run]
    masks_ok = want_masks is None or all(
        got["masks"][str(r)] == want_masks[r].tolist()
        for r in range(start, len(want_rows)))
    ok = (got["start"] == start and got["rows"] == want_rows
          and got["params"] == want_params and masks_ok)
    log(f"[check] preempt {name}: resumed at round {got['start']} (want "
        f"{start}), rows bit-equal {got['rows'] == want_rows}, params "
        f"sha256 equal {got['params'] == want_params}, masks equal "
        f"{masks_ok}; launches {got['launches']} {'OK' if ok else 'FAIL'}")
    if not ok:
        log(text[-4000:])
        raise AssertionError(f"{name}: the resumed run is not the "
                             f"uninterrupted one")
    return got


def preemption(dev, big) -> None:
    """Phase 5h: C4 first; the uninterrupted runs and the readings in
    this process; then the kills, together, and the resumes, together:
    the fast profile ``dcs`` killed after round 1's snapshot round-ahead
    and serially, the large fleet after round 0 (resumed plainly and
    under ``overflow@resume``, whose resumed round must launch
    ``neighbor_elect`` on its dense re-run), the event server after
    round 1 with a pending pool, the round-ahead snapshot torn (one
    byte flipped: the resume warns and falls back one round), the sweep
    killed at ``group-done:index=0`` and at ``checkpoint-saved:round=0``
    (byte-equal CSVs, the skip line where a group was finished, one
    ``probe_fuzzy`` a round a group); a snapshot crossing between the
    card and the CPU both ways."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs.mnist_cnn import CONFIG as CNN_CFG
    from repro_torch.fl.async_server import EventDrivenServer
    from repro_torch.fl.rounds import FLSimulation, run_schedule
    from repro_torch.launch.sweep import _group_ckpt_dir, fast_cell_config
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.models.cnn import init_cnn
    from repro_torch.train.checkpoint import (RoundCheckpointer, load_state,
                                              save_state)
    t0 = time.perf_counter()
    c4_determinism(dev)
    tmp = Path(tempfile.mkdtemp(prefix="preempt_"))
    try:
        # -- the uninterrupted runs, and the readings ---------------------
        fast_cfg, fast_run = preempt_config("fast")
        fast = FLSimulation(fast_cfg, run=fast_run, device=dev)
        p0 = {k: v.clone() for k, v in fast.params.items()}
        ra = schedule_run(fast, p0, PREEMPT_ROUNDS, True)
        se = schedule_run(fast, p0, PREEMPT_ROUNDS, False)
        if not (ra[0] == se[0] and same_params(ra[1], se[1])):
            raise AssertionError("round-ahead and serial rows differ")
        want_fast = (ra[0], params_digest(ra[1]), ra[3])
        snapshot_cost("fast profile (1 seed)", fast.capture_state,
                      tmp / "cost")
        cell_sims = [FLSimulation(fast_cell_config("dcs", 9, "uniform", s),
                                  run=RunConfig(), device=dev)
                     for s in range(4)]
        snapshot_cost("sweep group (4 seeds)", lambda: {
            "seeds": [s.capture_state() for s in cell_sims]}, tmp / "cost")
        del cell_sims
        big.params = init_cnn(torch.Generator().manual_seed(big.cfg.seed),
                              CNN_CFG, dev)
        big.participation[:] = 0
        lf = schedule_run(big, big.params, 2, True)
        want_large = (lf[0], params_digest(lf[1]), lf[3])
        snapshot_cost(f"large fleet ({big.n} vehicles)", big.capture_state,
                      tmp / "cost")
        ev_cfg, ev_run = preempt_config("event")
        ev_sim = FLSimulation(ev_cfg, run=ev_run, device=dev)
        ev = EventDrivenServer(ev_sim)
        ev_rows = run_schedule(ev, ev_sim, PREEMPT_ROUNDS, overlap=True)
        want_event = (ev_rows, params_digest(ev_sim.params))
        snapshot_cost(f"event server (pool of "
                      f"{sum(map(len, ev._pending.values()))} entries over "
                      f"ticks {sorted(ev._pending)})", ev.capture_state,
                      tmp / "cost")
        checkpoint_round_times(dev, tmp / "rounds_ck")
        sweep_out = tmp / "sweep.csv"
        s_def, l_def, want_csv = sweep_cli(PREEMPT_SWEEP_ARGV, sweep_out)
        s_dir, _, csv_dir = sweep_cli(
            PREEMPT_SWEEP_ARGV + ["--checkpoint-dir", str(tmp / "fresh")],
            tmp / "sweep_fresh.csv")
        log(f"[preempt] sweep {' '.join(PREEMPT_SWEEP_ARGV)} wall s: default "
            f"checkpoints ({sweep_out.name}.ckpt) {s_def:.2f}, "
            f"--checkpoint-dir a fresh directory {s_dir:.2f} (readings)")
        left = [p for p in (tmp / "fresh").rglob("round_*")]
        if csv_dir != want_csv or left or l_def["probe_fuzzy"] != 4:
            raise AssertionError(f"the sweep with checkpoints is wrong: "
                                 f"CSVs equal {csv_dir == want_csv}, "
                                 f"snapshots left {left}, launches {l_def}")

        # -- the card and the CPU share snapshots -------------------------
        cpu = FLSimulation(fast_cfg, run=fast_run, device="cpu")
        save_state(str(tmp / "card"), fast.capture_state())
        cpu.restore_state(*load_state(str(tmp / "card")))
        to_cpu = all(torch.equal(cpu.params[k], fast.params[k].cpu())
                     for k in fast.params)
        cpu.params = {k: v + 1.0 for k, v in cpu.params.items()}
        save_state(str(tmp / "cpu"), cpu.capture_state())
        fast.restore_state(*load_state(str(tmp / "cpu")))
        to_card = all(fast.params[k].is_cuda
                      and torch.equal(fast.params[k].cpu(), cpu.params[k])
                      for k in cpu.params)
        log(f"[check] a card snapshot restored on the CPU: params "
            f"bit-equal {to_cpu}; a CPU snapshot restored on the card: "
            f"{to_card} {'OK' if to_cpu and to_card else 'FAIL'}")
        if not (to_cpu and to_card):
            raise AssertionError("snapshots do not cross between the card "
                                 "and the CPU")
        del cpu

        # -- wave 1: the kills ------------------------------------------------
        d = {k: tmp / f"{k}_ck" for k in ("ra", "serial", "large", "event")}
        sweep_argv = ["-m", "repro_torch.launch.sweep", *PREEMPT_SWEEP_ARGV]
        kids = Children(tmp)
        t1 = time.perf_counter()
        for name, profile, overlap, rounds, plan in (
                ("ra", "fast", True, PREEMPT_ROUNDS,
                 "sigkill@checkpoint-saved:round=1"),
                ("serial", "fast", False, PREEMPT_ROUNDS,
                 "sigkill@checkpoint-saved:round=1"),
                ("large", "large", True, 2, "sigkill@checkpoint-saved:round=0"),
                ("event", "event", True, PREEMPT_ROUNDS,
                 "sigkill@checkpoint-saved:round=1")):
            kids.child(f"kill_{name}", dict(
                profile=profile, rounds=rounds, overlap=overlap,
                runs=[dict(dir=str(d[name]), resume=False)]), plan)
        for tag, plan in (("a", "sigkill@group-done:index=0"),
                          ("b", "sigkill@checkpoint-saved:round=0")):
            kids.start(f"kill_sweep_{tag}", sweep_argv + [
                "--out", str(tmp / f"sweep_{tag}.csv")], plan)
        res = kids.wait()
        log(f"[preempt] wave of kills: {len(res)} children in "
            f"{time.perf_counter() - t1:.1f}s")
        for name in ("ra", "serial", "event"):
            check_kill(f"kill_{name}", res, "checkpoint-saved (round=1)")
        check_kill("kill_large", res, "checkpoint-saved (round=0)")
        check_kill("kill_sweep_a", res, "group-done (index=0)")
        check_kill("kill_sweep_b", res, "checkpoint-saved (round=0)")
        on_disk = {k: RoundCheckpointer(str(v)).rounds_on_disk()
                   for k, v in d.items()}
        pending = load_state(str(d["event"] / "round_000001"))[0]["pending"]
        dcs_dir = Path(_group_ckpt_dir(str(tmp / "sweep_b.csv.ckpt"), "dcs",
                                       9, "uniform", RunConfig().resolved()))
        partial = (tmp / "sweep_a.csv").read_text().splitlines()
        ok = (on_disk == {"ra": [0, 1], "serial": [0, 1], "large": [0],
                          "event": [0, 1]}
              and bool(pending)
              and RoundCheckpointer(str(dcs_dir)).rounds_on_disk() == [0]
              and not (tmp / "sweep_b.csv").exists()
              and len(partial) == 1 + 4 * 2
              and all(",dcs," in line for line in partial[1:]))
        log(f"[check] after the kills: snapshots {on_disk}; the event "
            f"snapshot's pending pool {sum(map(len, pending.values()))} "
            f"entries over ticks {sorted(pending)}; the sweep killed at "
            f"group-done left {len(partial) - 1} dcs rows in its CSV, the "
            f"one killed at its first snapshot a round-0 snapshot and no "
            f"CSV {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the kills left other state than planned")

        # -- wave 2: the resumes ----------------------------------------------
        shutil.copytree(d["ra"], tmp / "torn_ck")
        shutil.copytree(d["large"], tmp / "large_ov_ck")
        torn = tmp / "torn_ck" / "round_000001" / "arrays.npz"
        flip = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.faults", "flipbyte",
             str(torn), str(TORN_OFFSET)], cwd=ROOT, capture_output=True,
            text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
        if flip.returncode != 0:
            raise AssertionError(f"faults flipbyte failed: {flip.stderr}")
        t1 = time.perf_counter()
        for name, profile, overlap, rounds, runs in (
                ("ra", "fast", True, PREEMPT_ROUNDS, [d["ra"]]),
                ("serial", "fast", False, PREEMPT_ROUNDS, [d["serial"]]),
                ("torn", "fast", True, PREEMPT_ROUNDS, [tmp / "torn_ck"]),
                ("large", "large", True, 2,
                 [d["large"], (tmp / "large_ov_ck", "overflow@resume")]),
                ("event", "event", True, PREEMPT_ROUNDS, [d["event"]])):
            steps = [dict(dir=str(r), resume=True) if isinstance(r, Path)
                     else dict(dir=str(r[0]), resume=True, switch=r[1])
                     for r in runs]
            kids.child(f"resume_{name}", dict(
                profile=profile, rounds=rounds, overlap=overlap, runs=steps))
        for tag in ("a", "b"):
            kids.start(f"resume_sweep_{tag}", sweep_argv + [
                "--out", str(tmp / f"sweep_{tag}.csv"), "--resume"])
        res = kids.wait()
        log(f"[preempt] wave of resumes: {len(res)} children in "
            f"{time.perf_counter() - t1:.1f}s")
        for name in ("ra", "serial"):
            check_resume(f"resume_{name}", res, *want_fast[:2], 2,
                         want_fast[2])
        check_resume("resume_event", res, *want_event, 2)
        check_resume("resume_torn", res, *want_fast[:2], 1, want_fast[2])
        warned = "skipping corrupt checkpoint" in res["resume_torn"][1]
        log(f"[check] preempt resume_torn: the flipped snapshot skipped with "
            f"a CheckpointCorruptWarning {warned} "
            f"{'OK' if warned else 'FAIL'}")
        if not warned:
            raise AssertionError("the torn snapshot was not reported")
        plain = check_resume("resume_large", res, want_large[0],
                             want_large[1], 1, run=0)
        over = check_resume("resume_large", res, want_large[0],
                            want_large[1], 1, run=1)
        ok = (over["launches"]["neighbor_elect"] >= 1
              and over["launches"]["windowed_counts"] == 1
              and over["masks"]["1"] == want_large[2][1].tolist()
              and plain["masks"]["1"] == want_large[2][1].tolist())
        log(f"[check] large fleet resumed under overflow@resume: round 1 "
            f"launched neighbor_elect {over['launches']['neighbor_elect']}"
            f" time(s) on its dense re-run (plain resume: "
            f"{plain['launches']['neighbor_elect']}), masks equal "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("overflow@resume did not take the dense "
                                 "re-run")
        for tag, skip, want_l in (("a", True, {"probe_fuzzy": 2,
                                               "neighbor_elect": 0}),
                                  ("b", False, {"probe_fuzzy": 3,
                                                "neighbor_elect": 1})):
            rc, text, _ = res[f"resume_sweep_{tag}"]
            csv = (tmp / f"sweep_{tag}.csv").read_text()
            m = re.search(r"\[sweep\] launches (\{.*\})", text)
            launches = json.loads(m.group(1)) if m else {}
            skipped = ("[sweep] resume: skipping completed group "
                       "dcs/9/uniform" in text)
            left = list((tmp / f"sweep_{tag}.csv.ckpt").rglob("round_*"))
            ok = (rc == 0 and csv == want_csv and skipped == skip
                  and all(launches.get(k) == v for k, v in want_l.items())
                  and not left)
            log(f"[check] preempt sweep resumed after the kill at "
                f"{'group-done' if skip else 'its first snapshot'}: exit "
                f"{rc}, CSV byte-equal {csv == want_csv}, skip line {skipped}"
                f" (want {skip}), launches {launches} (want {want_l}), "
                f"snapshots left {len(left)} {'OK' if ok else 'FAIL'}")
            if not ok:
                log(text[-4000:])
                raise AssertionError("the resumed sweep is wrong")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[preempt] phase 5h in {time.perf_counter() - t0:.1f}s")



# the cohort GEMM (ROADMAP C12) at the fast profile's local-SGD step:
# every product of one step, 20 samples a client, for one client alone
# and for a cohort of C_GEMM; conv2's input gradient in the cohort is the
# kernels line's headline
C_GEMM, B_GEMM = 4, 20
GEMM_HEADLINE = "conv2 input gradient"
# a step's products by their (R, K, M, N, Z1): the four bias gradients
# are products of their own where the weight gradient does not carry
# them as row sums (``cohort_gemm(..., rowsum=True)``)
STEP_PRODUCTS = {
    (1, 25, 32, 784, 20): "conv1 forward",
    (1, 800, 64, 196, 20): "conv2 forward",
    (1, 3136, 20, 512, 1): "fc1 forward",
    (1, 512, 20, 10, 1): "fc2 forward",
    (1, 10, 20, 512, 1): "fc2 input gradient",
    (1, 20, 10, 512, 1): "fc2 weight gradient",
    (1, 20, 1, 10, 1): "fc2 bias gradient",
    (1, 512, 20, 3136, 1): "fc1 input gradient",
    (1, 20, 512, 3136, 1): "fc1 weight gradient",
    (1, 20, 1, 512, 1): "fc1 bias gradient",
    (20, 196, 64, 800, 1): "conv2 weight gradient",
    (20, 196, 64, 1, 1): "conv2 bias gradient",
    (1, 64, 800, 196, 20): "conv2 input gradient",
    (20, 784, 32, 25, 1): "conv1 weight gradient",
    (20, 784, 32, 1, 1): "conv1 bias gradient",
}


def cublas_gemm(a, b, bias=None, rowsum=False):
    """The cohort's products as one batched ``torch.matmul`` (cuBLAS,
    which picks its kernel by the batch count) and a sum over R: the
    port's form before ROADMAP C12, for readings beside the kernel."""
    import torch
    out = torch.matmul(a, b).sum(2)
    out = (out + bias if bias is not None else out).contiguous()
    return (out, a.sum(dim=(2, 4))) if rowsum else out


def step_products(dev, c: int, seed: int = 27) -> list:
    """Every ``ops.cohort_gemm`` call of one local-SGD step of a cohort of
    ``c`` clients at the fast profile's widths (the CNN's init with small
    per-client offsets, ``B_GEMM`` random images a client, from
    ``seed``), as ``models/cnn.py`` makes them: ``[(label, a, b, bias,
    rowsum)]`` in the step's order."""
    import torch
    from repro_torch.configs.mnist_cnn import CONFIG
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    g = torch.Generator().manual_seed(seed)
    p = {k: (v[None] + 0.01 * torch.randn((c, *v.shape), generator=g))
         .to(dev).requires_grad_(True)
         for k, v in cnn.init_cnn(g, CONFIG).items()}
    images = torch.randn(c, B_GEMM, 28, 28, 1, generator=g).to(dev)
    labels = torch.randint(0, 10, (c, B_GEMM), generator=g).to(dev)
    calls, kernel = [], ops.cohort_gemm

    def record(a, b, bias=None, *rowsum):
        z1, _, r, m, k = a.shape
        label = STEP_PRODUCTS.get((r, k, m, b.shape[4], z1),
                                  f"R={r} K={k} M={m} N={b.shape[4]}")
        if rowsum and rowsum[0]:
            label += " + bias gradient"
        calls.append((label, a, b, bias, bool(rowsum and rowsum[0])))
        return kernel(a, b, bias, *rowsum)
    ops.cohort_gemm = record
    try:
        loss = cnn.sample_nll(cnn.cnn_forward_stacked(p, images),
                              labels).mean(-1)
        torch.autograd.grad(loss.sum(), list(p.values()))
    finally:
        ops.cohort_gemm = kernel
    return calls


def gemm_work(a, b, bias, rowsum) -> tuple:
    """(bytes, fp32 operations) of one ``cohort_gemm`` call: each
    operand's distinct elements (a broadcast axis once) read once, the
    outputs written once; 2 R K M N a (z1, z2) pair, plus R K M adds a
    row sum."""
    def distinct(t):
        return math.prod(n for n, st in zip(t.shape, t.stride()) if st)
    z1, z2, r, m, k = a.shape
    n = b.shape[4]
    n_bytes = a.element_size() * (
        distinct(a) + distinct(b) + z1 * z2 * m * n
        + (distinct(bias) if bias is not None else 0)
        + (z1 * z2 * m if rowsum else 0))
    ops_ = 2 * z1 * z2 * r * m * n * k + (z1 * z2 * r * m * k if rowsum
                                         else 0)
    return n_bytes, ops_


def cohort_gemm_phase(dev) -> tuple:
    """``cohort_gemm`` at every product of a local-SGD step, for one
    client alone and for a cohort of ``C_GEMM``: against its plain
    version (within 1e-5 of scale, the row sums too), bit-repeatable,
    and the cohort's last client's block equal to a call of that client
    alone; then each timed beside the plain version and one library
    call on the same views (``torch.matmul`` where R is 1,
    ``torch.einsum`` over (r, k) where the batch sum is the R axis; the
    bias gradients of a fused call not included): device time a call
    (``graph_ms``: calls replayed from a CUDA graph) and eager time
    (back-to-back calls, the host's launch cost included), with its
    bound at the 3xTF32 rate (operations as 3 TF32 passes at 495
    TFLOP/s) and at the fp32 peak.  Returns (max abs error, (ms, plain
    ms, bound ms, by) and library ms of conv2's input gradient in the
    cohort, the per-product rows)."""
    import torch
    from repro_torch.kernels import ops, ref
    err, rows, head = 0.0, [], None
    for c in (1, C_GEMM):
        calls = step_products(dev, c)
        tot = {}
        for label, a, bm, bias, rowsum in calls:
            extra = (True,) if rowsum else ()     # an older tree: none

            def kernel():
                return ops.cohort_gemm(a, bm, bias, *extra)

            def plain():
                return ref.cohort_gemm_ref(a, bm, bias, *extra)
            got, again, want = kernel(), kernel(), plain()
            one = ops.cohort_gemm(a[:, -1:], bm[:, -1:], None if bias is
                                  None else bias[:, -1:], *extra)
            torch.cuda.synchronize()
            outs = [(got, again, want, one)] if not rowsum else list(zip(
                got, again, want, one))
            e, ok = 0.0, True
            for x, y, w, o in outs:
                e = max(e, scaled_err(x, w))
                err = max(err, float((x - w).abs().max()))
                ok = (ok and torch.equal(x, y) and torch.equal(o[:, 0],
                                                               x[:, -1])
                      and bool(torch.isfinite(x).all()))
            ok = ok and e <= 1e-5
            z1, z2, r, m, k = a.shape
            n = bm.shape[4]
            if r == 1:
                lib, lib_name = (lambda: torch.matmul(a, bm)), "matmul"
            else:
                lib, lib_name = (lambda: torch.einsum(
                    "zcrmk,zcrkn->zcmn", a, bm)), "einsum"
            ms, lib_ms = graph_ms(kernel), graph_ms(lib)
            eager_ms, eager_lib_ms = time_ms(kernel, 50), time_ms(lib, 50)
            plain_ms = time_ms(plain, 10)
            n_bytes, n_ops = gemm_work(a, bm, bias, rowsum)
            b_ms, b_by = bound(n_bytes, 3 * n_ops, TF32_FLOP_PER_S)
            f_ms, f_by = bound(n_bytes, n_ops)
            for key, v in (("ms", ms), ("library_ms", lib_ms),
                           ("bound_ms", b_ms), ("eager_ms", eager_ms),
                           ("eager_library_ms", eager_lib_ms)):
                tot[key] = tot.get(key, 0.0) + v
            rows.append({"product": label, "clients": c, "ms": ms,
                         "eager_ms": eager_ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms,
                         "eager_library_ms": eager_lib_ms,
                         "library": f"torch.{lib_name}", "bound_ms": b_ms,
                         "bound_by": b_by, "fp32_bound_ms": f_ms,
                         "err_over_scale": e})
            log(f"[check] cohort_gemm C={c} {label} (Z1={z1} R={r} M={m} "
                f"K={k} N={n}): max err / scale {e:.3g} (tol 1e-5), "
                f"bit-repeatable and one client alone bit-equal {ok}")
            log(f"[time] cohort_gemm C={c} {label}: device kernel "
                f"{ms:.4f} ms, torch.{lib_name} {lib_ms:.4f} ms "
                f"({lib_ms / ms:.2f}x the kernel's); eager (host launch "
                f"included) {eager_ms:.4f} / {eager_lib_ms:.4f} ms; plain "
                f"{plain_ms:.4f} ms; bound 3xTF32 {b_ms:.6f} ms ({b_by}), "
                f"fp32 {f_ms:.6f} ms ({f_by})")
            if not ok:
                raise AssertionError(f"cohort_gemm C={c} {label} disagrees")
            if c == C_GEMM and label == GEMM_HEADLINE:
                head = ((ms, plain_ms, b_ms, b_by), lib_ms)
        log(f"[time] cohort_gemm C={c}: the step's {len(calls)} products, "
            f"device {tot['ms']:.4f} ms (torch's calls "
            f"{tot['library_ms']:.4f} ms), eager {tot['eager_ms']:.4f} ms "
            f"({tot['eager_library_ms']:.4f} ms), bound 3xTF32 "
            f"{tot['bound_ms']:.6f} ms")
    return err, head[0], head[1], rows


def seed_axis_kernels(dev, st, params, n, feats, big, bfeats) -> dict:
    """``probe_loss`` and ``fuzzy_eval`` with a leading axis of
    ``SWEEP_SEEDS`` seeds, one launch each: ``probe_loss`` at the sweep's
    fast packs (``st``, ``params`` stacked, N = ``n``) and at the 4-way
    mesh's large-fleet regions (the 4 regions of ``big``'s pack as 4
    seeds, each with its own weights, N = 4096), ``fuzzy_eval`` at P =
    30 (the seeds' ``feats``) and P = 4096 (``bfeats`` scaled per seed),
    with each seed's own Eq. 8 maxima and with external ones.  Each
    seed bit-equal to a launch of it alone, within tolerance of the
    plain version (losses 1e-5 of the largest, evals 1e-4 on [0, 100]),
    bit-repeatable; CUDA-event times against S single launches beside
    S x the single bound.  Returns the readings for the kernels line."""
    import torch
    from repro_torch.core.rules import build_rule_table
    from repro_torch.kernels import ops, ref
    from repro_torch.models.cnn import init_cnn
    from repro_torch.configs.mnist_cnn import CONFIG
    n_s = SWEEP_SEEDS
    table, levels = build_rule_table()
    mam = (big.statics.means, big.statics.sigmas, table, levels,
           big.statics.level_centers)
    mam_ref = (mam[0], mam[1], torch.as_tensor(table, device=dev),
               torch.as_tensor(levels, device=dev), mam[4])
    regions = [big.probe_region(4, d) for d in range(4)]
    bparams = [init_cnn(torch.Generator().manual_seed(d), CONFIG, dev)
               for d in range(n_s)]
    counts = big.statics.probe_counts
    loss_cases = {
        f"fast packs S={st.probe_images.shape[1]} N={n}": (
            params, st.probe_images, st.probe_labels, st.probe_seg,
            st.probe_counts, n),
        f"large-fleet 4-way regions S={regions[0][0].shape[0]} "
        f"N={big.n}": (
            {k: torch.stack([p[k] for p in bparams]) for k in bparams[0]},
            torch.stack([r[0] for r in regions]),
            torch.stack([r[1] for r in regions]),
            torch.stack([r[2] for r in regions]),
            counts[None].expand(n_s, -1).contiguous(), big.n)}
    param_bytes = sum(t[0].numel() * 4 for t in params.values())
    reading, err = {}, 0.0
    for label, (p, im, lb, sg, ct, nn) in loss_cases.items():
        call = lambda: ops.probe_loss(p, im, lb, sg, ct, n_clients=nn)
        singles = lambda: [ops.probe_loss(
            {k: v[i] for k, v in p.items()}, im[i], lb[i], sg[i], ct[i],
            n_clients=nn) for i in range(n_s)]
        got, again, one = call(), call(), singles()
        want = ref.probe_loss_ref(p, im, lb, sg, ct, nn)
        torch.cuda.synchronize()
        e = scaled_err(got, want)
        err = max(err, float((got - want).abs().max()))
        ok = (all(torch.equal(got[i], o) for i, o in enumerate(one))
              and torch.equal(got, again) and e <= 1e-5)
        log(f"[check] probe_loss seeds S={n_s} {label}: bit-equal to {n_s} "
            f"single launches and bit-repeatable "
            f"{ok and e <= 1e-5}, max err / scale against the plain "
            f"version {e:.3g} (tol 1e-5) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"seed-batched probe_loss {label} is wrong")
        s_rows = im.shape[1]
        b_ms, b_by = probe_bounds(s_rows * (28 * 28 * 4 + 8) + nn * 8
                                  + param_bytes, s_rows)[0]
        ms, single_ms = (time_ms(call, 5), time_ms(singles, 5))
        reading.setdefault("probe_loss", {
            "S": n_s, "shape": label, "ms": ms,
            f"single_x{n_s}_ms": single_ms, "bound_ms": n_s * b_ms,
            "bound_by": b_by})
        log(f"[time] probe_loss seeds S={n_s} {label}: one launch {ms:.4f} "
            f"ms, {n_s} single launches {single_ms:.4f} ms, bound {n_s} x "
            f"{b_ms:.4f} = {n_s * b_ms:.4f} ms ({b_by})")
    scale = torch.tensor([1.0, 1.01, 0.97, 1.03], device=dev)[:, None, None]
    fe_cases = {f"P={n}": feats.contiguous(),
                f"P={bfeats.shape[0]}": (bfeats[None] * scale).contiguous()}
    for label, x in fe_cases.items():
        for external in (False, True):
            cm = (x.max(dim=1).values * 1.05).contiguous() if external \
                else None
            call = lambda: ops.fuzzy_eval(x, *mam, normalize=True,
                                          col_maxima=cm)
            singles = lambda: [ops.fuzzy_eval(
                x[i], *mam, normalize=True,
                col_maxima=None if cm is None else cm[i])
                for i in range(n_s)]
            got, again, one = call(), call(), singles()
            want = ref.fuzzy_eval_ref(x, *mam_ref, normalize=True,
                                      col_maxima=cm)
            torch.cuda.synchronize()
            e = float((got - want).abs().max())
            err = max(err, e)
            ok = (all(torch.equal(got[i], o) for i, o in enumerate(one))
                  and torch.equal(got, again) and e <= 1e-4)
            which = "external maxima" if external else "own maxima"
            log(f"[check] fuzzy_eval seeds S={n_s} {label} {which}: "
                f"bit-equal to {n_s} single launches and bit-repeatable, "
                f"max abs err against the plain version {e:.3g} (tol 1e-4 "
                f"on [0, 100]) {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"seed-batched fuzzy_eval {label} "
                                     f"{which} is wrong")
            p = x.shape[1]
            b_ms, b_by = bound(p * 20, p * (MAMDANI_OPS + EQ8_OPS))
            ms, single_ms = time_ms(call, 200), time_ms(singles, 200)
            if external:
                reading.setdefault("fuzzy_eval", {
                    "S": n_s, "shape": f"{label} external maxima", "ms": ms,
                    f"single_x{n_s}_ms": single_ms, "bound_ms": n_s * b_ms,
                    "bound_by": b_by})
            log(f"[time] fuzzy_eval seeds S={n_s} {label} {which}: one "
                f"launch {ms:.4f} ms, {n_s} single launches "
                f"{single_ms:.4f} ms, bound {n_s} x {b_ms:.3g} = "
                f"{n_s * b_ms:.3g} ms ({b_by})")
    reading["err"] = err
    return reading


MESH_SWEEP_ARGV = SWEEP_FAST_ARGV + ["--mesh", "clients=2"]


def mesh_sweep(single_csv: str) -> dict:
    """``[mesh sweep]``: ``python -m repro_torch.launch.sweep
    MESH_SWEEP_ARGV`` (2 ranks on the card, rank 0 writing the CSV)
    against phase 5f's single-device CSV of the same grid: every row's
    integer columns equal, accuracy within 1e-5 (the mean evaluation a
    reading: round 1 starts from FedAvg sums added in another order);
    each rank launches ``probe_loss`` and ``fuzzy_eval`` once a round a
    group (for all its seeds), ``neighbor_elect`` once a round of the
    ``dcs`` group and ``probe_fuzzy`` never.  Returns the per-rank
    launches."""
    import tempfile
    from repro_torch.launch import sweep
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "mesh.csv"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.sweep",
             *MESH_SWEEP_ARGV, "--out", str(out)], cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
            capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        for line in proc.stdout.strip().splitlines():
            log(f"[mesh sweep] {line}")
        if proc.returncode != 0:
            log(proc.stderr[-4000:])
            raise AssertionError(f"sweep {MESH_SWEEP_ARGV} exited "
                                 f"{proc.returncode}")
        text = out.read_text()
    mine, want = sweep.parse_csv_rows(text), sweep.parse_csv_rows(single_csv)
    ints = ("round", "seed", "n_selected", "n_aggregated", "n_straggler",
            "n_active")
    same = (mine is not None and len(mine) == len(want) and all(
        all(a[k] == b[k] for k in ints + ("scheme",))
        and abs(a["accuracy"] - b["accuracy"]) <= 1e-5
        for a, b in zip(mine, want)))
    acc_gap = max(abs(a["accuracy"] - b["accuracy"])
                  for a, b in zip(mine, want))
    ev_gap = max(abs(a["mean_eval_selected"] - b["mean_eval_selected"])
                 for a, b in zip(mine, want))
    ranks = [json.loads(line.split("launches ", 1)[1].split(
        ", host-staged")[0]) for line in proc.stdout.splitlines()
        if line.startswith("[sweep] rank ")]
    groups, rounds = 3, 2
    want_l = {"probe_loss": groups * rounds, "fuzzy_eval": groups * rounds,
              "neighbor_elect": rounds}
    launch_ok = len(ranks) == 2 and all(
        prefix_launches(r) == {k: want_l.get(k, 0) for k in
                               prefix_launches(r)}
        and r["cohort_gemm"] > 0 for r in ranks)
    ok = (same and launch_ok and "[sweep] client mesh: {'clients': 2}"
          in proc.stdout)
    log(f"[check] mesh sweep {' '.join(MESH_SWEEP_ARGV)} ({secs:.1f}s): "
        f"{len(mine)} rows, integer columns equal to the single-device "
        f"sweep's and accuracy within 1e-5 {same} (largest accuracy gap "
        f"{acc_gap:.3g}, mean evaluation gap {ev_gap:.3g}, a reading); "
        f"launches per rank {ranks} (want {want_l}: one probe_loss and one "
        f"fuzzy_eval a round a group for all its seeds) "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the sweep on the mesh differs from one device")
    return ranks[0]


def with_run(sim, run):
    """``sim`` as built under ``run`` without building its dataset again:
    a shallow copy with the run config, the prefix's stage config and
    fresh bookkeeping."""
    import copy
    import numpy as np
    new = copy.copy(sim)
    new.run_cfg = run.resolved()
    new.stage_cfg = new.run_cfg.to_stage_config(sim.cfg, n_clients=sim.n)
    new.participation = np.zeros_like(sim.participation)
    new.last_mask = None
    return new


def event_rounds(sim, n_rounds: int) -> dict:
    """``n_rounds`` serial rounds of ``sim.driver()`` (resuming from the
    run config's snapshots when it says so): the rows, each round's mask
    and params (``r{round}.{name}``) run here, the launches and, on a
    mesh, the host-staged collectives."""
    import numpy as np
    from repro_torch.fl.rounds import run_resumable
    from repro_torch.kernels import build
    out = {}

    def on_row(r, host, row):
        out[f"mask{r}"] = np.asarray(sim.last_mask)
        out.update({f"r{r}.{k}": v.cpu().numpy()
                    for k, v in sim.params.items()})
    build.reset_launches()
    rows = run_resumable(sim.driver(), sim, n_rounds, overlap=False,
                         on_row=on_row)
    out.update(rows=rows, launches=dict(build.LAUNCHES),
               staged=dict(sim.mesh.staged) if sim.mesh else {})
    return out


def event_rank(mesh, cfg, run, n_rounds: int) -> dict:
    """One rank of ``[mesh event]`` / ``[mesh resume]``."""
    from repro_torch.fl.rounds import FLSimulation
    return event_rounds(FLSimulation(cfg, run=run, mesh=mesh), n_rounds)


EVENT_INT_KEYS = ("round", "n_selected", "n_aggregated", "n_straggler",
                  "n_active", "stale_frac", "n_effective",
                  "rounds_behind_hist")


def compare_event(label: str, ranks, single, n_rounds: int) -> None:
    """K ranks' event-server rounds against one device's: every rank's
    rows equal, the rows' integer and async columns and each round's
    mask equal to one device's, accuracy within 1e-5; the params gap per
    round logged."""
    import numpy as np
    rows = ranks[0]["rows"]
    gaps, same = [], all(r["rows"] == rows for r in ranks)
    for r in range(n_rounds):
        a, b = rows[r], single["rows"][r]
        same = same and all(a[k] == b[k] for k in EVENT_INT_KEYS) and abs(
            a["accuracy"] - b["accuracy"]) <= 1e-5 and np.array_equal(
            ranks[0][f"mask{r}"], single[f"mask{r}"])
        keys = [k for k in single if k.startswith(f"r{r}.")]
        gaps.append(max(float(np.abs(ranks[0][k] - single[k]).max())
                        for k in keys))
    agg = sum(r["n_aggregated"] for r in rows)
    ok = same and agg > 0
    log(f"[check] mesh event {label}, {n_rounds} rounds on {len(ranks)} "
        f"ranks vs one device: rows' integer and async columns, masks and "
        f"accuracy (tol 1e-5) equal {same}; aggregated {agg}; params max "
        f"abs gap per round {[f'{g:.3g}' for g in gaps]} (a reading); rank "
        f"0 launches {ranks[0]['launches']}, host-staged "
        f"{ranks[0]['staged']} {'OK' if ok else 'FAIL'}")
    log(f"[mesh event] {label} rows {json.dumps(rows)}")
    if not ok:
        raise AssertionError(f"the mesh event server ({label}) differs "
                             f"from one device")


MESH_EVENT_ROUNDS = 3
LARGE_EVENT_ROUNDS = 2


def mesh_event(dev) -> tuple:
    """``[mesh event]``, the fast profile on 2 ranks with phase 5g's
    event server (churn 0.2, weighted lambda 0.5, a 1.5-period cadence)
    for ``MESH_EVENT_ROUNDS`` rounds against the same run on one device
    (``compare_event``).  Returns (the event run config, the 2 ranks'
    results) for ``mesh_resume``."""
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.launch.mesh import spawn_ranks
    cfg = fast_config_dcs(MESH_EVENT_ROUNDS)
    run = RunConfig(overlap_rounds=False, **EVENT_RUN,
                    agg_cadence_s=EVENT_CADENCE_PERIODS * cfg.deadline_s)
    single = event_rounds(FLSimulation(cfg, run=run, device=dev),
                          MESH_EVENT_ROUNDS)
    t0 = time.perf_counter()
    ranks = spawn_ranks(event_rank, 2, dev.type, args=(
        cfg, dataclasses.replace(run, mesh="clients=2"), MESH_EVENT_ROUNDS))
    log(f"[mesh event] fast profile on 2 ranks: "
        f"{time.perf_counter() - t0:.1f}s with start-up")
    compare_event("fast profile, churn 0.2, weighted lambda 0.5, cadence "
                  f"{EVENT_CADENCE_PERIODS} periods", ranks, single,
                  MESH_EVENT_ROUNDS)
    return cfg, run, ranks


def mesh_resume(dev, cfg, run, ranks) -> None:
    """``[mesh resume]``: the 2-rank event server of ``mesh_event``
    killed by ``sigkill@checkpoint-saved:round=0`` (rank 0, after it
    wrote round 0's snapshot, whose pool holds pending partial sums
    ``num`` / ``den``), then resumed by 2 fresh ranks: rows and the final
    params' sha256 equal to the uninterrupted run's."""
    import tempfile
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.train.checkpoint import RoundCheckpointer, load_state
    mrun = dataclasses.replace(run, mesh="clients=2")
    last = MESH_EVENT_ROUNDS - 1
    import torch

    def digest(res):
        return params_digest({k[len(f"r{last}."):]: torch.as_tensor(v)
                              for k, v in res.items()
                              if k.startswith(f"r{last}.")})
    want = digest(ranks[0])
    with tempfile.TemporaryDirectory() as tmp:
        ck = dataclasses.replace(mrun, checkpoint_dir=tmp)
        os.environ["REPRO_FAULTS"] = "sigkill@checkpoint-saved:round=0"
        try:
            spawn_ranks(event_rank, 2, dev.type,
                        args=(cfg, ck, MESH_EVENT_ROUNDS))
            killed = "ran to its end"
        except RuntimeError as err:
            killed = ("rank 0 killed by SIGKILL" if "rank 0 (exit -9)"
                      in str(err) else str(err)[-300:])
        finally:
            del os.environ["REPRO_FAULTS"]
        state, extra = load_state(RoundCheckpointer(tmp).path_for(0))
        pending = [it for items in state["pending"].values()
                   for it in items]
        res = spawn_ranks(event_rank, 2, dev.type, args=(
            cfg, dataclasses.replace(ck, resume=True), MESH_EVENT_ROUNDS))
    got = [digest(r) for r in res]
    pool_ok = bool(pending) and all({"num", "den"} <= set(it)
                                    for it in pending)
    ok = (killed == "rank 0 killed by SIGKILL" and pool_ok
          and all(r["rows"] == ranks[0]["rows"] for r in res)
          and all(g == want for g in got))
    log(f"[check] mesh resume: the 2-rank event server {killed} after "
        f"round 0's snapshot ({len(pending)} pending pool entries, each "
        f"with num and den {pool_ok}); 2 fresh ranks resumed at round "
        f"{extra['next_round']}: rows equal the uninterrupted run's "
        f"{all(r['rows'] == ranks[0]['rows'] for r in res)}, params sha256 "
        f"{got[0][:16]} == {want[:16]} {all(g == want for g in got)} "
        f"{'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the mesh event server does not resume bit "
                             "for bit")


# phase 6's small kernels: the CUDA kernels each wrapper launches
SMALL_KERNEL_NAMES = {"fuzzy_eval": ("fuzzy_eval_kernel",),
                      "neighbor_elect": ("neighbor_elect_kernel",),
                      "windowed_counts": ("windowed_counts_kernel",)}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2

    from repro_torch.configs import get_arch
    from repro_torch.core.elect import auto_window
    from repro_torch.core.rules import build_rule_table
    from repro_torch.device import fp32_strict
    from repro_torch.fl import pipeline
    from repro_torch.fl.rounds import FLSimulation
    from repro_torch.fl.runconfig import RunConfig
    from repro_torch.fl.schemes import elect_window
    from repro_torch.kernels import build, ops, ref
    from repro_torch.launch.fl_sim import fast_config

    # -- 1. the card -------------------------------------------------------
    fp32_strict()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {kind}; {count} device(s); torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(smi)                          # name, power limit (nvidia-smi)

    # each phase's wall seconds, logged where the next begins (the run's
    # time limit is what an added phase has to fit in)
    t_phase = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        log(f"[time] phase {name} in {now - t_phase[0]:.1f}s")
        t_phase[0] = now

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {len(paths)} kernels in {time.perf_counter() - t0:.1f}s")
    for name in build.KERNELS:
        fn = ""
        for line in build.build_log(name).splitlines():
            fn = ptxas_function(line) or fn
            if any(w in line for w in ("registers", "spill", "wgmma")):
                log(f"[build] {name} {fn}: {line.strip()}")

    table, levels = build_rule_table()

    # the main path's tensors: the fast-profile dcs simulation's round 0
    sim = FLSimulation(fast_config("dcs", n_rounds=3), run=RunConfig(),
                       device=dev)
    st, fields0 = sim.statics, sim.round_fields(0)
    pos0 = pipeline.positions(st, sim.stage_cfg,
                              torch.zeros((), device=dev))
    aux0 = pipeline.aux_features(st, sim.stage_cfg, pos0, fields0)
    s_main, n_main = st.probe_images.shape[0], sim.n
    log(f"[main path] probe S={s_main} N={n_main}")

    # the large-fleet path: its uniform and extreme placements share one
    # dataset; the uniform one's round 0 gives the path's shapes
    t0 = time.perf_counter()
    with one_dataset():
        big = FLSimulation(large_fleet_config("uniform"), run=RunConfig(),
                           device=dev)
        big_x = FLSimulation(large_fleet_config("extreme"),
                             run=RunConfig(), device=dev)
    big_cfg = big.stage_cfg
    window_big = elect_window(big_cfg)
    bst, bfields0 = big.statics, big.round_fields(0)
    bpos0 = pipeline.positions(bst, big_cfg, torch.zeros((), device=dev))
    big_probe = (big.params, bst.probe_images, bst.probe_labels,
                 bst.probe_seg, bst.probe_counts,
                 pipeline.aux_features(bst, big_cfg, bpos0, bfields0))
    s_big4k = bst.probe_images.shape[0]
    log(f"[large fleet] built both placements in "
        f"{time.perf_counter() - t0:.1f}s: probe S={s_big4k} N={big.n}, "
        f"elect={big_cfg.elect!r}, window {window_big} per side")
    if big_cfg.elect != "windowed":
        raise AssertionError("elect='auto' did not resolve to windowed")

    # the Mamdani operands as the kernel wrappers and as the plain
    # versions take them (the plain ones want the rule table as tensors)
    mam = (st.means, st.sigmas, table, levels, st.level_centers)
    mam_ref = (st.means, st.sigmas, torch.as_tensor(table, device=dev),
               torch.as_tensor(levels, device=dev), st.level_centers)
    main_probe = (sim.params, st.probe_images, st.probe_labels,
                  st.probe_seg, st.probe_counts, aux0)

    phase_done("2")

    # -- 3. kernels against their plain versions -----------------------------
    def check_probe(label, inputs, n, col_maxima=None):
        f, e = ops.probe_fuzzy(*inputs, *mam, n_clients=n,
                               col_maxima=col_maxima)
        f0, e0 = ref.probe_fuzzy_ref(*inputs, *mam_ref, n_clients=n,
                                     col_maxima=col_maxima)
        torch.cuda.synchronize()
        # fp32 sums in another order (conv/GEMM tiling, client sums):
        # per-client losses to 1e-4 relative, evals 1e-3 on [0, 100]
        lf_rel = float(((f[:, 3] - f0[:, 3]).abs()
                        / f0[:, 3].abs().clamp(min=1e-12)).max())
        ev_abs = float((e - e0).abs().max())
        ok = (lf_rel <= 1e-4 and ev_abs <= 1e-3
              and bool(torch.isfinite(e).all())
              and torch.equal(f[:, :3], f0[:, :3]))
        log(f"[check] probe_fuzzy {label}: loss max rel err {lf_rel:.3g} "
            f"(tol 1e-4), eval max abs err {ev_abs:.3g} (tol 1e-3) "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"probe_fuzzy {label} disagrees")
        return f, e, ev_abs

    feats_main, evals0, err_probe = check_probe(
        f"S={s_main} N={n_main}", main_probe, n_main)
    bfeats0, bevals0, err_probe_big = check_probe(
        f"S={s_big4k} N={big.n} (large fleet)", big_probe, big.n)
    err_probe = max(err_probe, err_probe_big)
    # the Eq. 8 seam with external column maxima
    check_probe(f"S={s_main} N={n_main} col_maxima", main_probe, n_main,
                col_maxima=feats_main.max(dim=0).values * 1.25)

    g = torch.Generator(device=dev).manual_seed(11)
    n_big, per = 1024, 256
    s_big = n_big * per
    big_seg = torch.arange(n_big, device=dev,
                           dtype=torch.int32).repeat_interleave(per)
    big_seg[::97] = n_big                      # overflow-lane padding rows
    check_probe(f"S={s_big} N={n_big}", (
        sim.params,
        torch.randn(s_big, 28, 28, 1, device=dev, generator=g),
        torch.randint(0, 10, (s_big,), device=dev, generator=g,
                      dtype=torch.int32),
        big_seg, torch.bincount(big_seg, minlength=n_big + 1)[:n_big].int(),
        torch.rand(n_big, 3, device=dev, generator=g)
        * torch.tensor([4500.0, 3e6, 1.0], device=dev)), n_big)

    x_big = torch.rand(TOKYO_FLEET, 4, device=dev, generator=g) * torch.tensor(
        [4500.0, 3e6, 1.0, 3.0], device=dev)
    x_mesh = x_big[:LARGE_FLEET].contiguous()
    err_fuzzy = 0.0
    for label, x in ((f"P={n_main}", feats_main),
                     (f"P={LARGE_FLEET}", x_mesh),
                     (f"P={TOKYO_FLEET}", x_big)):
        for normalize in (False, True):
            xin = x if normalize else (x / x.max(dim=0).values)
            got = ops.fuzzy_eval(xin, *mam, normalize=normalize)
            again = ops.fuzzy_eval(xin, *mam, normalize=normalize)
            want = ref.fuzzy_eval_ref(xin, *mam_ref, normalize=normalize)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            same = torch.equal(got, again)
            if x is feats_main:
                err_fuzzy = max(err_fuzzy, err)
            ok = err <= 1e-4 and same
            log(f"[check] fuzzy_eval {label} normalize={normalize}: max abs "
                f"err {err:.3g} (tol 1e-4), bit-repeatable {same} "
                f"{'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"fuzzy_eval {label} disagrees")

    cfg = sim.stage_cfg
    elect_kw = dict(comm_range=cfg.comm_range_m, top_m=cfg.top_m,
                    e_tau=cfg.e_tau)
    rng = np.random.default_rng(5)
    elect_cases = [("N=30", pos0.contiguous(), evals0.contiguous())]
    for n in (4096, 16384):
        pos = rng.uniform(0, 1000 * n / 30, n).astype(np.float32)
        ev = rng.uniform(0, 100, n).astype(np.float32)
        pos[:6] = [100, 300, 300, 500, 700, 900]       # d == comm_range
        ev[:6] = [50, 50, 50, 30, 30, 29.999]           # ties, E_tau
        ev[6:40] = 50.0
        elect_cases.append((f"N={n}", torch.tensor(pos, device=dev),
                            torch.tensor(ev, device=dev)))
    for label, pos, ev in elect_cases:
        got = ops.neighbor_elect(pos, ev, **elect_kw)
        want = ref.neighbor_elect_ref(pos, ev, **elect_kw)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        log(f"[check] neighbor_elect {label}: bit-equal {same}, "
            f"{int(want.sum())} selected {'OK' if same else 'FAIL'}")
        if not same:
            raise AssertionError(f"neighbor_elect {label} not bit-equal")

    # windowed counts: bit-equal, on sorted arrays the election builds
    # (M a multiple of the block, so no padding): the large fleet's
    # round 0, a 65,536-vehicle fleet at 1 per metre, a clustered fleet
    def sorted_fleet(pos, ev):
        order = torch.argsort(pos, stable=True)
        return pos[order], ev[order], order.to(torch.int32)

    def uniform_fleet(n, seed):
        r = np.random.default_rng(seed)
        pos = r.uniform(0, n, n).astype(np.float32)
        ev = r.uniform(0, 100, n).astype(np.float32)
        pos[:6] = [100, 300, 300, 500, 700, 900]       # d == comm_range
        ev[:6] = [50, 50, 50, 30, 30, 29.999]           # ties, E_tau
        ev[6:40] = 50.0
        return (torch.tensor(pos, device=dev), torch.tensor(ev, device=dev))

    clustered = uniform_fleet(LARGE_FLEET, 7)
    clustered[0][: LARGE_FLEET // 2] = torch.rand(
        LARGE_FLEET // 2, device=dev, generator=g) * 150.0
    fleets = {"large fleet round 0": (bpos0.contiguous(),
                                      bevals0.contiguous()),
              "N=65536 1/m": uniform_fleet(65536, 6),
              f"N={LARGE_FLEET} clustered": clustered}
    count_kw = dict(comm_range=big_cfg.comm_range_m, e_tau=big_cfg.e_tau)
    win_cases = {}
    for label, (pos, ev) in fleets.items():
        m = pos.shape[0]
        sp, se, sg = sorted_fleet(pos, ev)
        win_cases[label] = (sp, se, sg)
        for window in sorted({16, 300, auto_window(m, 200.0, float(m))}):
            kw = dict(count_kw, n_valid=m, window=window, block=128)
            got = ops.windowed_counts(sp, se, sg, **kw)
            want = ref.windowed_counts_ref(sp, se, sg, **kw)
            again = ops.windowed_counts(sp, se, sg, **kw)
            torch.cuda.synchronize()
            same = torch.equal(got, want) and torch.equal(got, again)
            log(f"[check] windowed_counts {label} M={m} window {window}: "
                f"bit-equal and repeatable {same}, counts sum "
                f"{int(want.sum())} {'OK' if same else 'FAIL'}")
            if not same:
                raise AssertionError(f"windowed_counts {label} differs")

    # the windowed election against the dense kernel and the oracle
    for label, (pos, ev) in fleets.items():
        m = pos.shape[0]
        if m != LARGE_FLEET:
            continue
        dense = ops.neighbor_elect(pos, ev, **elect_kw)
        for window in (16, 64, auto_window(m, 200.0, float(m))):
            mask, ovf = ops.neighbor_elect_windowed(pos, ev, window=window,
                                                    **elect_kw)
            _, oracle = ref.windowed_elect_ref(pos, ev, window=window,
                                               **elect_kw)
            ovf, oracle = int(ovf), int(oracle)
            ok = ovf >= oracle and (ovf == 1 or torch.equal(mask, dense))
            log(f"[check] windowed election {label} window {window}: "
                f"flag {ovf} (oracle {oracle}), mask equals dense "
                f"{torch.equal(mask, dense)} {'OK' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"windowed election {label} wrong")

    # wkv6 at the serving prefill's shape and at a long sequence: the
    # kernel's fp32 y and sT against the plain version's, both fp32
    # recurrences from the same operands summed in other orders, to 1e-5
    # of the largest magnitude; and bit for bit against a second launch
    from repro_torch.kernels.wkv6 import wkv6_cuda
    wkv_cases = {}
    err_wkv = 0.0
    g_edge = torch.Generator(device=dev).manual_seed(19)
    for b, t, h, edge in ([(WKV_B, WKV_T, WKV_H, False),
                           (1, 4096, WKV_H, False)]
                          + [(*c, True) for c in WKV_EDGE]):
        args = wkv_inputs(b, t, h, g_edge if edge else g, dev, edge=edge)
        if not edge:
            wkv_cases[(b, t)] = args
        y, s_t = wkv6_cuda(*args)
        y2, s_t2 = wkv6_cuda(*args)
        want_y, want_s = ref.wkv6_ref(*args)
        torch.cuda.synchronize()
        e_y, e_s = scaled_err(y, want_y), scaled_err(s_t, want_s)
        same = torch.equal(y, y2) and torch.equal(s_t, s_t2)
        ok = (e_y <= 1e-5 and e_s <= 1e-5 and same
              and bool(torch.isfinite(y).all()))
        if (b, t, edge) == (WKV_B, WKV_T, False):
            err_wkv = float((y - want_y).abs().max())
        log(f"[check] wkv6 B={b} T={t} H={h} N={WKV_N} bf16 r/k/v"
            f"{', edge decays' if edge else ''}: y max err / scale "
            f"{e_y:.3g} (scale {float(want_y.abs().max()):.4g}), sT "
            f"{e_s:.3g} (tol 1e-5); bit-repeatable {same} "
            f"{'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"wkv6 B={b} T={t} H={h} edge={edge} "
                                 f"disagrees")
        del args, y, y2, s_t, s_t2, want_y, want_s

    phase_done("3")

    # -- 4. timing -----------------------------------------------------------
    param_bytes = sum(t.numel() * 4 for t in sim.params.values())
    probe_bytes = (s_main * (28 * 28 * 4 + 8) + n_main * (4 + 12 + 16 + 4)
                   + param_bytes)
    pos_big, ev_big = elect_cases[-1][1:]
    n_eb, p_big = pos_big.shape[0], x_big.shape[0]
    sp_b, se_b, sg_b = win_cases["large fleet round 0"]
    sp_h, se_h, sg_h = win_cases["N=65536 1/m"]
    wkw_b = dict(count_kw, n_valid=big.n, window=window_big, block=128)
    window_h = auto_window(65536, 200.0, 65536.0)
    wkw_h = dict(count_kw, n_valid=65536, window=window_h, block=128)
    cr_big = big_cfg.comm_range_m
    # name -> (shape, kernel call, plain call, iterations, (bound, by));
    # the first row of each kernel is its path's shape
    cases = [
        ("probe_fuzzy", f"S={s_main} N={n_main}",
         lambda: ops.probe_fuzzy(*main_probe, *mam, n_clients=n_main),
         lambda: ref.probe_fuzzy_ref(*main_probe, *mam_ref,
                                     n_clients=n_main), 20,
         probe_bounds(probe_bytes, s_main)[0]),
        ("fuzzy_eval", f"P={n_main} normalize=True",
         lambda: ops.fuzzy_eval(feats_main, *mam, normalize=True),
         lambda: ref.fuzzy_eval_ref(feats_main, *mam_ref, normalize=True),
         200, bound(n_main * 20, n_main * (MAMDANI_OPS + EQ8_OPS))),
        ("neighbor_elect", f"N={n_main}",
         lambda: ops.neighbor_elect(pos0, evals0, **elect_kw),
         lambda: ref.neighbor_elect_ref(pos0, evals0, **elect_kw), 200,
         bound(n_main * 12, n_main * n_main * ELECT_OPS_PER_PAIR)),
        ("probe_fuzzy", f"S={s_big4k} N={big.n} (large fleet)",
         lambda: ops.probe_fuzzy(*big_probe, *mam, n_clients=big.n),
         lambda: ref.probe_fuzzy_ref(*big_probe, *mam_ref,
                                     n_clients=big.n), 3,
         probe_bounds(s_big4k * (28 * 28 * 4 + 8) + big.n * 36
                      + param_bytes, s_big4k)[0]),
        ("windowed_counts", f"M={big.n} window {window_big}",
         lambda: ops.windowed_counts(sp_b, se_b, sg_b, **wkw_b),
         lambda: ref.windowed_counts_ref(sp_b, se_b, sg_b, **wkw_b), 200,
         bound(big.n * 16, in_range_pairs(sp_b, 128, window_big, cr_big)
               * ELECT_OPS_PER_PAIR)),
        ("windowed_counts", f"M=65536 window {window_h}",
         lambda: ops.windowed_counts(sp_h, se_h, sg_h, **wkw_h),
         lambda: ref.windowed_counts_ref(sp_h, se_h, sg_h, **wkw_h), 200,
         bound(65536 * 16, in_range_pairs(sp_h, 128, window_h, cr_big)
               * ELECT_OPS_PER_PAIR)),
        ("fuzzy_eval", f"P={LARGE_FLEET} normalize=True",
         lambda: ops.fuzzy_eval(x_mesh, *mam, normalize=True),
         lambda: ref.fuzzy_eval_ref(x_mesh, *mam_ref, normalize=True), 200,
         bound(LARGE_FLEET * 20, LARGE_FLEET * (MAMDANI_OPS + EQ8_OPS))),
        ("fuzzy_eval", f"P={p_big} normalize=True",
         lambda: ops.fuzzy_eval(x_big, *mam, normalize=True),
         lambda: ref.fuzzy_eval_ref(x_big, *mam_ref, normalize=True), 20,
         bound(p_big * 20, p_big * (MAMDANI_OPS + EQ8_OPS))),
        ("neighbor_elect", f"N={n_eb}",
         lambda: ops.neighbor_elect(pos_big, ev_big, **elect_kw),
         lambda: ref.neighbor_elect_ref(pos_big, ev_big, **elect_kw), 20,
         bound(n_eb * 12, n_eb * n_eb * ELECT_OPS_PER_PAIR)),
    ]
    for (b, t), args in wkv_cases.items():
        cases.append((
            "wkv6", f"B={b} T={t} H={WKV_H} N={WKV_N} bf16",
            functools.partial(wkv6_cuda, *args),
            functools.partial(ref.wkv6_ref, *args),
            200 if t <= WKV_T else 5, wkv_bound(b, t, WKV_H)))
    timings, event_ms = {}, {}
    for name, shape, fn, plain, iters, (b_ms, b_by) in cases:
        ms, plain_ms = time_ms(fn, iters), time_ms(plain, iters)
        timings.setdefault(name, (ms, plain_ms, b_ms, b_by))
        event_ms[(name, shape)] = ms
        log(f"[time] {name} {shape}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    err_gemm, timings["cohort_gemm"], gemm_lib_ms, gemm_rows = \
        cohort_gemm_phase(dev)
    for (b, t) in wkv_cases:
        d_ms, d_by = wkv_design_bound(b, t, WKV_H)
        f_ms, f_by = wkv_bound(b, t, WKV_H)
        log(f"[bound] wkv6 B={b} T={t} H={WKV_H} N={WKV_N}: function "
            f"{f_ms:.6f} ms ({f_by}); the chunked design's own work "
            f"{d_ms:.6f} ms ({d_by})")
    # windowed_counts: the bound of the pairs in range (the JSON's) beside
    # that of every pair its window visits, the Pallas kernel's work
    for (m, window, sp_w) in ((big.n, window_big, sp_b),
                              (65536, window_h, sp_h)):
        n_in = in_range_pairs(sp_w, 128, window, cr_big)
        n_vis = visited_pairs(m, 128, window)
        (i_ms, i_by), (v_ms, v_by) = (
            bound(m * 16, n * ELECT_OPS_PER_PAIR) for n in (n_in, n_vis))
        log(f"[bound] windowed_counts M={m} window {window}: pairs in range "
            f"{n_in} ({i_ms:.6f} ms, {i_by}), pairs visited {n_vis} "
            f"({v_ms:.6f} ms, {v_by})")
    # the probe's two bounds (its time by phase comes last: see there)
    probe_packs = (
        (f"S={s_main} N={n_main}", s_main, probe_bytes, main_probe, n_main),
        (f"S={s_big4k} N={big.n} (large fleet)", s_big4k,
         s_big4k * (28 * 28 * 4 + 8) + big.n * 36 + param_bytes, big_probe,
         big.n))
    for label, s_rows, n_bytes, _, _ in probe_packs:
        (d_ms, d_by), (f_ms, f_by) = probe_bounds(n_bytes, s_rows)
        log(f"[bound] probe_fuzzy {label}: {d_ms:.6f} ms ({d_by}; 3xTF32 "
            f"design, the one measured against), fp32 {f_ms:.6f} ms "
            f"({f_by})")

    # the whole windowed election (sort, counts, coverage, scatter)
    # against the dense kernel, at 1 vehicle per metre
    for n in (LARGE_FLEET, 16384, 65536):
        pos, ev = (fleets["large fleet round 0"] if n == LARGE_FLEET
                   else uniform_fleet(n, n))
        window = auto_window(n, 200.0, float(n))
        win_ms = time_ms(lambda: ops.neighbor_elect_windowed(
            pos, ev, window=window, **elect_kw), 50)
        dense_ms = time_ms(lambda: ops.neighbor_elect(pos, ev, **elect_kw),
                           50)
        log(f"[time] election N={n} window {window}: windowed "
            f"{win_ms:.4f} ms, dense kernel {dense_ms:.4f} ms, "
            f"windowed/dense {win_ms / dense_ms:.3f}")

    phase_done("4")

    # -- 5. the main path ------------------------------------------------------
    # the round-0 prefix on the card against the port's CPU plain path
    cpu_sim = FLSimulation(fast_config("dcs", n_rounds=3), run=RunConfig(),
                           device="cpu")
    cpu_sim.params = {k: v.cpu() for k, v in sim.params.items()}
    got = sim.selection_state(0, fields0)
    want = cpu_sim.selection_state(0)
    ev_err = float((got["evals"].cpu() - want["evals"]).abs().max())
    same_mask = torch.equal(got["mask"].cpu(), want["mask"])
    log(f"[check] prefix round 0 cuda vs cpu: eval max abs err {ev_err:.3g} "
        f"(tol 1e-3), masks equal {same_mask}")
    if ev_err > 1e-3 or not same_mask:
        raise AssertionError("the card's prefix disagrees with the CPU's")
    del cpu_sim
    fast0 = got

    def drive(s, n_rounds, label):
        build.reset_launches()
        rows = []
        for r in range(n_rounds):
            # run_round's two halves, timed apart: the prefix on the card,
            # then the gather, local SGD, FedAvg and the accuracy
            fields = s.round_fields(r)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state = s.selection_state(r, fields)
            torch.cuda.synchronize()
            t_prefix = time.perf_counter()
            row = s.finish_round(r, state, fields)
            torch.cuda.synchronize()
            row["prefix_s"] = t_prefix - t
            row["round_s"] = time.perf_counter() - t
            row["elect_overflow"] = int(state["elect_overflow"])
            rows.append(row)
            log(f"[main path] {label} {json.dumps(row)}")
        counts = dict(build.LAUNCHES)
        log(f"[main path] {label} launches {counts}")
        for row in rows:
            if not (0.0 <= row["accuracy"] <= 1.0
                    and math.isfinite(row["mean_eval_selected"])
                    and 0 <= row["n_aggregated"] <= row["n_selected"]
                    <= s.n):
                raise AssertionError(f"bad row {row}")
        for t in s.params.values():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError("non-finite params after training")
        return counts, rows

    def max_gap(a, b):
        return max(float((a[k].cpu() - b[k].cpu()).abs().max()) for k in a)

    def accuracies(rows):
        return [round(row["accuracy"], 4) for row in rows]

    params0 = {k: v.clone() for k, v in sim.params.items()}
    fused, rows_a = drive(sim, 3, "dcs fused")
    params_a = sim.params

    # the same 3 rounds again from the same params: cuDNN's default
    # algorithms may sum in another order from run to run
    sim.params = {k: v.clone() for k, v in params0.items()}
    _, rows_b = drive(sim, 3, "dcs fused repeat")
    log(f"[repeat] default algorithms: accuracy {accuracies(rows_a)} / "
        f"{accuracies(rows_b)}, params max abs gap after 3 rounds "
        f"{max_gap(params_a, sim.params):.3g}")

    # round 0's training half (cohort gather, grouped-conv local SGD,
    # FedAvg) on the card against the port's CPU path, fed the same
    # survivors, draws and params.  In fp32 the two sum in another order
    # and a ReLU or max-pool kink that flips on one side moves the params
    # by ~lr * grad, so the fp32 gap is a reading, beside the CPU's own
    # gap when its start is nudged by one ulp.  In fp64 no kink flips:
    # the params must agree to 1e-6 (FedAvg still sums in fp32).
    fields = sim.round_fields(0)
    survivors = sim.selection_state(0, fields)["survivors"].cpu().numpy()
    c = sim.cfg

    def train_half(params, groups):
        trained = pipeline.train_groups(
            params, pipeline.device_groups(
                groups, next(iter(params.values())).device),
            sim._group_steps, survivors,
            lambda i: fields.perms[i], epochs=c.local_epochs,
            batch_size=c.batch_size, lr=c.lr)
        return pipeline.aggregate(params, trained)

    def on(device, dtype):
        return {k: v.to(device, dtype) for k, v in params0.items()}

    groups64 = [dataclasses.replace(g, images=g.images.astype(np.float64))
                for g in sim.groups]
    gap64 = max_gap(train_half(on(dev, torch.float64), groups64),
                    train_half(on("cpu", torch.float64), groups64))
    cpu32 = train_half(on("cpu", torch.float32), sim.groups)
    gap32 = max_gap(train_half(on(dev, torch.float32), sim.groups), cpu32)
    nudged = {k: torch.nextafter(v, torch.full_like(v, math.inf))
              for k, v in on("cpu", torch.float32).items()}
    gap_ulp = max_gap(train_half(nudged, sim.groups), cpu32)
    log(f"[check] round 0 training+FedAvg cuda vs cpu: params max abs err "
        f"fp64 {gap64:.3g} (tol 1e-6) {'OK' if gap64 <= 1e-6 else 'FAIL'}; "
        f"fp32 {gap32:.3g} (the CPU against itself from a start one ulp "
        f"up: {gap_ulp:.3g})")
    if gap64 > 1e-6:
        raise AssertionError("the card's training disagrees with the CPU's")

    # deterministic algorithms: the 3 rounds replayed twice must repeat
    # bit for bit, rows and params
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    replays = []
    for _ in range(2):
        sim.params = {k: v.clone() for k, v in params0.items()}
        replays.append((sim.run(3), sim.params))
    torch.use_deterministic_algorithms(False)
    torch.backends.cudnn.deterministic = False
    (rows_c, params_c), (rows_d, params_d) = replays
    same = rows_c == rows_d and max_gap(params_c, params_d) == 0.0
    log(f"[check] deterministic replay: accuracy {accuracies(rows_c)} / "
        f"{accuracies(rows_d)}, rows and params bit-equal {same} "
        f"{'OK' if same else 'FAIL'}")
    if not same:
        raise AssertionError("deterministic rounds on the card do not repeat")

    unfused_sim = FLSimulation(fast_config("dcs", n_rounds=1),
                               run=RunConfig(fused_probe=False), device=dev)
    unfused, _ = drive(unfused_sim, 1, "dcs unfused")
    # the large fleet through elect="auto": round 0's windowed mask is
    # the dense election's (flag 0), then 2 rounds launch windowed_counts
    # once each and neighbor_elect only for a round that overflowed
    state_w = big.selection_state(0, bfields0)
    state_g = big.selection_state(0, bfields0, elect="gather")
    flag0 = int(state_w["elect_overflow"])
    _, oracle0 = ref.windowed_elect_ref(state_w["pos"], state_w["evals"],
                                        window=window_big, **elect_kw)
    last_ev = float(state_w["evals"][torch.argmax(state_w["pos"])])
    same = torch.equal(state_w["mask"], state_g["mask"])
    log(f"[check] large fleet round 0: overflow {flag0} (oracle "
        f"{int(oracle0)}; last vehicle's eval {last_ev:.3f}), windowed "
        f"mask equals gather's {same}, {int(state_w['n_selected'])} "
        f"selected")
    if flag0 < int(oracle0) or (flag0 == 0 and not same):
        raise AssertionError("large fleet: windowed election is wrong")
    big0 = {"mask": state_g["mask"].cpu(), "evals": state_w["evals"].cpu(),
            "pos": state_w["pos"].cpu()}
    del state_w, state_g
    windowed, rows_w = drive(big, 2, "large fleet uniform")
    n_over = sum(row["elect_overflow"] for row in rows_w)
    if n_over:
        log(f"[main path] large fleet uniform: {n_over} round(s) "
            f"overflowed the window and ran the dense fallback")
    if (windowed["windowed_counts"] != 2
            or windowed["neighbor_elect"] != n_over
            or any(row["n_selected"] <= 0 for row in rows_w)):
        raise AssertionError(f"large fleet uniform: launches {windowed}, "
                             f"rows {rows_w}")

    # the extreme placement crowds half the fleet into 150 m: the window
    # overflows and the round runs on the dense kernel's masks, the same
    # as elect="gather" gives
    xfields = big_x.round_fields(0)
    flag_x = int(big_x.selection_state(0, xfields)["elect_overflow"])
    gather_x = big_x.selection_state(0, xfields,
                                     elect="gather")["mask"].cpu().numpy()
    fallback, rows_x = drive(big_x, 1, "large fleet extreme")
    same = bool(np.array_equal(big_x.last_mask, gather_x))
    log(f"[check] large fleet extreme: overflow {flag_x}, round mask "
        f"equals gather's {same}")
    if (flag_x != 1 or rows_x[0]["elect_overflow"] != 1 or not same
            or fallback["neighbor_elect"] != 1
            or fallback["windowed_counts"] != 1
            or rows_x[0]["n_selected"] <= 0):
        raise AssertionError(f"large fleet extreme: launches {fallback}, "
                             f"rows {rows_x}")

    # rwkv6-3b with 2 layers at full width: the card against the port's
    # CPU path, then the serving path through its CLI at full width
    model_check("rwkv6-3b", dev, ("S", "x_tm", "x_cm"))
    served = serve_path("rwkv6-3b", {"wkv6": get_arch("rwkv6-3b").num_layers},
                        dev, argv=SERVE_ARGV)
    # the same CLI with one 4096-token prompt: wkv6 past one time chunk
    gc.collect()
    torch.cuda.empty_cache()
    serve_path("rwkv6-3b", {"wkv6": get_arch("rwkv6-3b").num_layers}, dev,
               argv=LONG_SERVE_ARGV)

    phase_done("5")

    # -- 5b. the dense family: flash_attention, then gemma-2b ----------------
    gc.collect()                      # the rwkv6 weights are gone
    torch.cuda.empty_cache()
    err_flash = flash_checks(dev)[FLASH_CASES[0]]
    flash_timing = flash_times(dev)[0]
    model_check("gemma-2b", dev, ("k", "v"), exact=("pos", "idx"))
    served_dense = serve_path(
        "gemma-2b", {"flash_attention": get_arch("gemma-2b").num_layers},
        dev, argv=GEMMA_SERVE_ARGV)

    phase_done("5b")

    # -- 5t. LM training: flash_attention's backward, a train step, the CLI
    gc.collect()                      # the gemma-2b weights are gone
    torch.cuda.empty_cache()
    t5t = time.perf_counter()
    err_bwd = flash_bwd_checks(dev)
    bwd_rows = flash_bwd_times(dev)
    # the recurrences' backwards (wkv6_bwd, selective_scan_bwd), then a
    # 2-layer full-width step of each trained family against the CPU and
    # the full paths
    err_rec = recurrence_bwd_checks(dev)
    rec_rows = recurrence_bwd_times(dev)
    checked = {arch: train_check(dev, arch) for arch in TRAIN_CHECKS}
    trained = {arch: train_path(dev, arch) for arch in TRAIN_PATHS}
    log(f"[train] phase 5t in {time.perf_counter() - t5t:.1f}s")

    phase_done("5t")

    # -- 5c. the hybrid family: selective_scan, then jamba-v0.1-52b --------
    gc.collect()                      # the gemma-2b weights are gone
    torch.cuda.empty_cache()
    err_scan = scan_checks(dev)
    scan_timing, scan_event_ms = scan_times(dev)
    model_check(JAMBA, dev, ("k", "v", "conv", "h"), exact=("pos", "idx"),
                changes=JAMBA_CHECK)
    jamba = get_arch(JAMBA)
    jamba16 = dataclasses.replace(
        jamba, num_layers=JAMBA_GROUPS * jamba.attn_layer_period)
    kinds = [jamba16.layer_kind(i % jamba16.attn_layer_period)
             for i in range(jamba16.num_layers)]
    served_hybrid = serve_path(
        JAMBA, {"selective_scan": kinds.count("mamba"),
                "flash_attention": kinds.count("attn")}, dev, cfg=jamba16,
        **JAMBA_SERVE)
    # serve() again with one 4096-token prompt (it draws its weights
    # anew: the first serve's are freed when it returns)
    gc.collect()
    torch.cuda.empty_cache()
    serve_path(JAMBA, {"selective_scan": kinds.count("mamba"),
                       "flash_attention": kinds.count("attn")}, dev,
               cfg=jamba16, **JAMBA_LONG_SERVE)

    phase_done("5c")

    # -- 5i. the rest of the LM zoo: flash_attention's other paths --------
    gc.collect()                      # the jamba weights are gone
    torch.cuda.empty_cache()
    zoo = zoo_phase(dev)
    c13_moe_fp32(dev)

    phase_done("5i")

    # -- 5d. the client mesh, with probe_loss -------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    loss_timing, err_loss = probe_loss_phase(
        dev, big, big_probe, bfeats0, main_probe, feats_main)
    nccl_world_one(dev, sim, params0, fields0, fast0)
    mesh_fast(dev)
    mesh_launches = mesh_large_fleet(dev, big0, big)
    mesh_resume(dev, *mesh_event(dev))

    phase_done("5d")

    # -- 5e. the paper's profile, the loop engine, FedProx, --out -----------
    gc.collect()
    torch.cuda.empty_cache()
    paper_launches = paper_round(dev)
    engines_and_prox(dev)
    c8_step_check(dev)
    c12_engines(dev)
    round_profile(dev)
    paper_clis()

    phase_done("5e")

    # -- 5f. the multi-seed sweep: seed-batched probe_fuzzy and election --
    gc.collect()
    torch.cuda.empty_cache()
    sweep_reading = sweep_phase(dev, big, bfeats0)

    phase_done("5f")

    # -- 5g. the round drivers: round-ahead by default, the event server --
    gc.collect()
    torch.cuda.empty_cache()
    round_drivers(dev, big, bpos0, bevals0, window_big)

    phase_done("5g")

    # -- 5h. preemption: checkpoints, kills and resumes ---------------------
    gc.collect()
    torch.cuda.empty_cache()
    preemption(dev, big)

    launches = {"probe_fuzzy": fused["probe_fuzzy"],
                "neighbor_elect": fused["neighbor_elect"],
                "fuzzy_eval": unfused["fuzzy_eval"],
                "windowed_counts": windowed["windowed_counts"],
                "wkv6": served["wkv6"],
                "flash_attention": served_dense["flash_attention"],
                "selective_scan": served_hybrid["selective_scan"],
                "probe_loss": mesh_launches["probe_loss"],
                "cohort_gemm": fused["cohort_gemm"],
                "flash_attention_bwd":
                    trained["gemma-2b"]["launches"]["flash_attention_bwd"],
                # jamba trains only as its 2-layer check on one card
                "wkv6_bwd": trained["rwkv6-3b"]["launches"]["wkv6_bwd"],
                "selective_scan_bwd": checked[JAMBA]["selective_scan_bwd"]}
    if (min(launches.values()) <= 0 or unfused["neighbor_elect"] <= 0
            or windowed["probe_fuzzy"] != 2 + n_over
            or paper_launches["probe_fuzzy"] != 1):
        raise AssertionError(f"a kernel of the path never ran: {launches}")

    # the probe's time split by phase, after every other timing: once
    # torch.profiler has run, launches in this process cost more (host-
    # timed launch loops read ~0.015-0.025 ms slower)
    gc.collect()
    torch.cuda.empty_cache()
    for label, _, _, inputs, n in probe_packs:
        log_probe_phases(f"probe_fuzzy {label}", functools.partial(
            ops.probe_fuzzy, *inputs, *mam, n_clients=n),
            event_ms[("probe_fuzzy", label)])
    # wkv6 by phase and selective_scan, device time per launch at both
    # shapes, beside the CUDA-event time of back-to-back wrapper calls
    for (b, t), args in wkv_cases.items():
        shape = f"B={b} T={t} H={WKV_H} N={WKV_N} bf16"
        ms = phase_ms(functools.partial(wkv6_cuda, *args), WKV_PHASES,
                      calls=5, optional=("B", "C") if t <= 64 else ())
        log(f"[profile] wkv6 {shape}: " + ", ".join(
            f"phase {k} {v:.4f} ms" for k, v in ms.items())
            + f"; device {sum(ms.values()):.4f} ms a launch; CUDA events "
            f"over back-to-back wrapper calls "
            f"{event_ms[('wkv6', shape)]:.4f} ms")
    from repro_torch.kernels.selective_scan import selective_scan_cuda
    for case, ev_ms in scan_event_ms.items():
        args = scan_inputs(case, torch.bfloat16, dev, seed=2)
        ms = phase_ms(functools.partial(selective_scan_cuda, *args),
                      SCAN_PHASES, calls=5)
        log(f"[profile] selective_scan {scan_label(case, torch.bfloat16)}"
            f": device {ms['scan']:.4f} ms a launch; CUDA events over "
            f"back-to-back wrapper calls {ev_ms:.4f} ms")

    # the small kernels: device time per launch beside the CUDA-event
    # time of back-to-back wrapper calls (host-bound at these sizes) and
    # a one-element in-place add, the card's launch floor
    one = torch.zeros(1, device=dev)
    floor_ms = phase_ms(lambda: one.add_(1.0),
                        (("add", ("at::native::",)),), calls=200)["add"]
    log(f"[profile] launch floor: a one-element in-place add, device "
        f"{floor_ms:.4f} ms a launch")
    small = {("fuzzy_eval", f"P={n_main} normalize=True"),
             ("fuzzy_eval", f"P={LARGE_FLEET} normalize=True"),
             ("neighbor_elect", f"N={n_main}"),
             ("windowed_counts", f"M={big.n} window {window_big}"),
             ("windowed_counts", f"M=65536 window {window_h}")}
    for name, shape, fn, _, _, (b_ms, b_by) in cases:
        if (name, shape) not in small:
            continue
        ms = phase_ms(fn, ((name, SMALL_KERNEL_NAMES[name]),), calls=200)
        log(f"[profile] {name} {shape}: device {ms[name]:.4f} ms a launch "
            f"({ms[name] / floor_ms:.2f}x the floor, bound {b_ms:.6f} ms "
            f"{b_by}); CUDA events over back-to-back wrapper calls "
            f"{event_ms[(name, shape)]:.4f} ms")

    # flash_attention's backward at FLASH_BWD_TIMED: device time a launch
    # by kernel (dQ, dK/dV, the dK/dV sum)
    bwd_device = [log_flash_bwd_phases(case, call, row)
                  for case, (row, call) in zip(FLASH_BWD_TIMED, bwd_rows)]

    # the recurrences' backwards at the training microbatches: device
    # time a launch by phase (wkv6_bwd: A rows, A cols, B, C; the scan: A,
    # B, C and the ordered sums)
    for name, phases in (("wkv6_bwd", WKV_BWD_PHASES),
                         ("selective_scan_bwd", SCAN_BWD_PHASES)):
        row = rec_rows[name]
        log_bwd_phases(name, row, phases)

    # the seed-batched kernels: device time of one launch for the sweep's
    # S seeds against S single launches, beside the bound scaled by S
    for name, phases in (
            ("probe_fuzzy", PROBE_PHASES),
            ("neighbor_elect",
             (("elect", SMALL_KERNEL_NAMES["neighbor_elect"]),))):
        rd = sweep_reading[name]
        fn, single_fn = rd.pop("calls")
        kw = (dict(calls=5, busy=True) if name == "probe_fuzzy"
              else dict(calls=200))
        single_key = f"single_x{rd['S']}_device_ms"
        rd["device_ms"] = sum(phase_ms(fn, phases, **kw).values())
        rd[single_key] = sum(phase_ms(single_fn, phases, **kw).values())
        log(f"[profile] {name} seeds S={rd['S']}: device "
            f"{rd['device_ms']:.4f} ms a seed-batched launch, "
            f"{rd[single_key]:.4f} ms for {rd['S']} single launches; bound "
            f"{rd['bound_ms']:.6f} ms ({rd['bound_by']})")

    phase_done("5h and the [profile] readings")

    # -- 6. the kernels line ---------------------------------------------------
    meta = {
        "probe_fuzzy": ("src/repro_torch/csrc/probe_fuzzy.cu",
                        "src/repro/kernels/probe_fuzzy.py:230", err_probe),
        "fuzzy_eval": ("src/repro_torch/csrc/fuzzy_eval.cu",
                       "src/repro/kernels/fuzzy_eval.py:101", err_fuzzy),
        "neighbor_elect": ("src/repro_torch/csrc/neighbor_elect.cu",
                           "src/repro/kernels/neighbor_elect.py:66", 0.0),
        "windowed_counts": ("src/repro_torch/csrc/windowed_counts.cu",
                            "src/repro/kernels/neighbor_elect.py:141", 0.0),
        "wkv6": ("src/repro_torch/csrc/wkv6.cu",
                 "src/repro/kernels/wkv6.py:62", err_wkv),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:79",
                            err_flash),
        "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                           "src/repro/kernels/selective_scan.py:68",
                           err_scan),
        "probe_loss": ("src/repro_torch/csrc/probe_loss.cu",
                       "src/repro/kernels/probe_fuzzy.py:203", err_loss),
        # no Pallas kernel: the reference's local SGD is XLA's products
        # under vmap (value_and_grad at fl/client.py:300)
        "cohort_gemm": ("src/repro_torch/csrc/cohort_gemm.cu",
                        "src/repro/fl/client.py:300 (XLA, no Pallas "
                        "kernel)", err_gemm),
        # the training use of flash_attention_pallas: the reference has
        # no Pallas backward and differentiates its jnp attention
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention_bwd.cu",
                                "src/repro/kernels/flash_attention.py:79",
                                err_bwd[GEMMA_TRAIN_FLASH]),
        # the training uses of wkv6_pallas and selective_scan_pallas: the
        # reference differentiates its jnp scans
        "wkv6_bwd": ("src/repro_torch/csrc/wkv6_bwd.cu",
                     "src/repro/kernels/wkv6.py:62", err_rec["wkv6_bwd"]),
        "selective_scan_bwd": ("src/repro_torch/csrc/selective_scan_bwd.cu",
                               "src/repro/kernels/selective_scan.py:68",
                               err_rec["selective_scan_bwd"]),
    }
    computes = {
        "wkv6_bwd": "the vjp of src/repro/models/rwkv6.py:102 wkv6_chunked "
                    "(the reference's default wkv6, src/repro/kernels/"
                    "ops.py:33; its autodiff, no Pallas backward)",
        "selective_scan_bwd": "the vjp of src/repro/models/mamba.py:54 "
                              "_ssm_scan (the reference's autodiff; no "
                              "Pallas backward)"}
    timings["flash_attention"] = flash_timing[:4]
    timings["selective_scan"] = scan_timing
    timings["probe_loss"] = loss_timing
    timings["flash_attention_bwd"] = bwd_rows[0][0][:4]
    for name in computes:
        timings[name] = rec_rows[name]["timing"]
    library = {"flash_attention": flash_timing[4],
               "cohort_gemm": gemm_lib_ms,
               "flash_attention_bwd": bwd_rows[0][0][4]}
    kernels, others = [], []
    for name in build.KERNELS:
        src, replaces, err = meta[name]
        ms, plain_ms, b_ms, b_by = timings[name]
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": library.get(name)}
        if name in sweep_reading:        # the sweep's seed-batched launch
            # probe_loss and fuzzy_eval run seed-batched on the mesh
            # sweep: its rank 0's launches
            runs = sweep_reading["mesh_launches" if name in (
                "probe_loss", "fuzzy_eval") else "launches"]
            entry["seeds"] = dict(sweep_reading[name], launches=runs[name])
        if name == "flash_attention":    # phase 5i's paths
            entry["paths"] = [
                dict(zip(("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms"), row), path=path,
                     shape=flash_label(case, torch.bfloat16),
                     launches=zoo["served"][arch][name],
                     max_abs_err=zoo["err"][case])
                for (path, arch, case), row in zip(
                    (("whisper-medium encoder", "whisper-medium",
                      WHISPER_ENC_FLASH),
                     ("paligemma-3b prefix-LM prefill", "paligemma-3b",
                      PALIGEMMA_FLASH)), zoo["timing"])]
        if name == "flash_attention_bwd":
            entry["computes"] = ("the vjp of src/repro/models/attention.py"
                                 ":48 flash_attention (the reference's "
                                 "autodiff; no Pallas backward)")
            entry["shape"] = flash_label(GEMMA_TRAIN_FLASH, torch.bfloat16)
            entry["device_ms"] = bwd_device[0]
            entry["paths"] = [
                dict(zip(("ms", "plain_ms", "bound_ms", "bound_by",
                          "library_ms"), bwd_rows[i][0]),
                     path=path, shape=flash_label(case, torch.bfloat16),
                     device_ms=bwd_device[i], max_abs_err=err_bwd[case])
                for i, (path, case) in enumerate(
                    (("gemma-2b training microbatch (the step's launch)",
                      GEMMA_STEP_FLASH),
                     ("minicpm-2b training shape", MINICPM_TRAIN_FLASH)),
                    start=1)]
        if name in computes:
            row = rec_rows[name]
            entry.update(computes=computes[name], shape=row["shape"],
                         device_ms=row["device_ms"],
                         device_phase_ms=row["phase_ms"],
                         autograd_plain_ms=row["autograd_ms"],
                         design_bound_ms=row["design_ms"],
                         design_bound_by=row["design_by"])
        if name == "cohort_gemm":        # ports no Pallas kernel
            entry["reference"] = entry.pop("replaces")
            entry["products"] = gemm_rows
            others.append(entry)
        else:
            kernels.append(entry)
    print(json.dumps({"kernels": kernels, "other_kernels": others}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--preempt-child"]:
        sys.exit(preempt_child(sys.argv[2]))
    if sys.argv[1:] == ["--c12-readings"]:
        sys.exit(c12_readings())
    if sys.argv[1:2] == ["--train-child"]:
        sys.exit(train_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--gemm-readings"]:
        sys.exit(gemm_readings(*sys.argv[2:3]))
    if sys.argv[1:2] == ["--flash-parent"] and len(sys.argv) == 3:
        sys.exit(flash_parent(sys.argv[2]))
    if sys.argv[1:2] == ["--wkv-parent"] and len(sys.argv) == 3:
        sys.exit(recurrence_parent("wkv6_bwd", sys.argv[2]))
    if sys.argv[1:2] == ["--scan-parent"] and len(sys.argv) == 3:
        sys.exit(recurrence_parent("selective_scan_bwd", sys.argv[2]))
    sys.exit(main())
