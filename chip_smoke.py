#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases, each printing JSON lines; any failure exits non-zero:

1. device — the card (as ``nvidia-smi`` names it, with its power limit), the
   torch and CUDA versions, and the seconds the kernel build took (``nvcc``,
   one process per source, into ``build/``).
2. kernels — each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the serving paths give it, with the tolerances
   below; kernel, plain-version and library-yardstick times (CUDA events,
   L2 flushed before every timed call, the host's enqueue hidden behind a
   GPU spin: the card's time alone) and the least time the card could take
   (``bound_ms``).  The MPO-linear forward runs the tensor-core kernel
   (``csrc/mpo_linear_mma.cu``) in both dtypes, and ``csrc/mpo_linear.cu``
   (float32 on the tensor cores too, for the shapes the first's plan
   refuses) at a narrow float32 matrix (smoke bert-base's wq); every case
   checks that two launches give the same bits, and that its plan's shared
   memory and workspace match the CUDA source's and stay under a quarter of
   a bf16 W.  Flash
   decode (split-K) at bert-base's and qwen3-14b's geometry, ragged lengths,
   softcap, page and split boundaries, both dtypes, two launches
   bit-identical, the previous serial kernel timed beside it (``prev_ms``).
   The SSD scan at mamba2-130m's path shape (8 x 512, 24 heads of 64, state 128, chunk
   128), a 100-token prompt (q = 100) and one 4096-token prompt (32 chunks),
   both dtypes: two launches bit-identical, its plan's shared memory,
   scratch and launch-3 blocks an SM equal to the CUDA source's, and each of
   its three launches timed
   alone (``launch_ms``: chunk states, state passing, chunk outputs); the
   MPO-linear forward at bert-base's matrices (M = 1, 8,
   100 at attn and 1024), at mamba2-130m's in_proj (768 -> 3352; M = 1, 8,
   100 and 4096) and out_proj (1536 -> 768; M = 8 and 4096), and its tied
   head (768 -> 50432, M = 8), both dtypes; in bf16 at the dense LLM
   configurations' matrices: gemma2-27b's wq (4608 -> 4096, M = 8 and 4096)
   and tied head (4608 -> 256000, M = 8), mistral-nemo-12b's w_up (5120 ->
   14336, M = 4096), nemotron-4-15b's wq (6144 -> 6144, M = 8 and 4096).
   Flash decode also at gemma2-27b's geometry (KV = 16, G = 2, Dh = 128,
   softcap 50, a 64-key window's bias), mistral-nemo-12b's (KV = 8, G = 4)
   and nemotron-4-15b's (KV = 8, G = 6), ragged, both dtypes.
3. path — full-width bert-base served from 8 prompts of 128 tokens,
   ``serve(8, 256, paged=True)``, 32 generated tokens, once with the weight
   cache and once factorized through the MPO-linear kernel.  Launch counts
   are zeroed just before each run and read just after; every full-width
   path must launch the tensor-core forward (factorized bert-base,
   mamba2-130m both ways through its tied head, fine-tuning, the float32
   runs of phase 4), never csrc/mpo_linear.cu, and no plain version.  Then
   full-width mamba2-130m (bf16) served from 8 prompts of 512 tokens,
   ``serve(8, 544)``, 32 generated tokens, both ways: 24 SSD-scan launches a
   prefill, no plain-version call; then each run's bf16 prefill layer by
   layer, every block and the head on the card against the same on the CPU
   (plain versions) from the same input.
4. parity — float32 bert-base: greedy tokens of paged + factorized, paged +
   weight cache and the dense cache must be identical; float32 mamba2-130m
   with and without the weight cache, the decode fed the cached run's greedy
   tokens: logits within ``F32_TIE`` of their largest magnitude at every
   step, greedy tokens where they differ reported with their top-2 margins
   (each with its wall time), 24 SSD-scan launches a prefill; then the smoke bert-base and
   mamba2-130m models on the card against the same models on the CPU (plain
   versions), launching the forward kernels the float32 plan names for their
   matrices (both).
5. train — (a) the MPO-linear cores-backward kernel against its plain
   version at bert-base's attention, w_up and w_down shapes, M = 2048 (16 x
   128 tokens) and a ragged M, both dtypes, with its times: two launches
   bit-identical, a call with the central core skipped (``needs``) giving
   the other cores the same bits, the plan's shared memory and workspace
   equal to the CUDA source's, the workspace below an f32 dW; and the forward
   kernel against its plain version at M = 2048 over each matrix's cores and
   their i/j-swapped form (the dL/dx product), both dtypes; (b) full-width
   bert-base, bf16, ``Session.finetune(mode="lfa", seq_len=128,
   batch_size=16, steps=8)`` on the card: launch counts zeroed just before
   and read just after, finite losses, the LFA parameter counts, central
   cores bit-unchanged, ms per step; (c) the float32 smoke model with every
   matmul in the kernel mode: one train step's gradients and a 3-step loss
   trajectory on the card against the same on the CPU (plain versions),
   launching both forward kernels as the float32 plan says and the
   cores-backward kernel (no plain-version call).
6. lifecycle — the paper's workflow on full-width bert-base (bf16):
   (a) Algorithm 1, exact: ``Session.from_dense`` of a dense tree whose
   matrices are the reconstructions of a random MPO init (rank <= the bonds),
   conversion error <= 1e-4, float32 prefill logits against the source
   model's within ``SMOKE_TOL``; (b) Algorithm 1, truncated: the port's dense
   build (full-rank Gaussian), every matrix's (every layer's) error within
   Eq. 4's bound; (c) ``finetune(mode="lfa")`` on (a)'s session, both
   MPO-linear kernels launched, no plain version; (d) Algorithm 2: four
   calls of ``squeeze(step=1, max_iters=1, finetune_steps=4, delta=1.0)`` at
   16 x 128 (every iteration is accepted, so each call's tree is the one its
   iteration chose from): four events, each predicted error against a
   float64 recount from each layer's ``bond_spectra`` of the tree it was
   chosen from and its bond an argmin, rho falling, every matrix that
   planned ``kernel`` still planning it, kernel launches in the re-tunes
   (counted apart from the evaluations'), the seconds of each iteration's
   spectra, tt_round, re-tune and evaluation; both kernels at every distinct
   squeezed core shape against their plain versions (M = 2048, bf16); (e)
   the squeezed model served, ``serve(8, 160, paged=True)`` both ways: a new
   weights version, the cached W the squeezed cores' contraction rounded
   once to bf16 (bit for bit), prefill logits of the two runs within ``PATH_TOL``, flash
   and forward launches; (f) cuSOLVER against LAPACK: the smoke model's exact conversion
   and three squeeze moves on the card and on the CPU, the same
   (layer, bond, new_dim) sequence, predicted errors and reconstructions
   within 1e-4.
7. persistence — full-width bert-base (bf16) preempted and resumed:
   (a) ``finetune(mode="lfa")`` at 16 x 128, 8 steps, uninterrupted, and
   preempted at step 4 (``FaultPlan(preempt_finetune_step=4)``: the drain
   save is step 4) then resumed: parameters and AdamW state bit-identical,
   both MPO-linear kernels launched in the resumed run, no plain version;
   one save's seconds and bytes, and the step time with a checkpoint every
   2 steps beside none; (b) the squeeze journal: phase 6's squeeze settings,
   ``max_iters=3``, uninterrupted from a cloned start, and preempted at
   iteration 1 then resumed: the same history (all but ``seconds``), tree
   bit-identical, rho equal, each journal record's seconds; (c)
   ``Session.save`` of the squeezed session and ``Session.restore`` on the
   card: stage, version, records, mask and every leaf equal, ``serve(8,
   160, paged=True)`` both ways giving the saved session's greedy tokens
   (flash with the weight cache, the forward kernel without), and every
   leaf of a ``device="cpu"`` restore bit-equal; save and restore seconds,
   restore to the first served token, the directory's MB; (d) full-width
   mamba2-130m saved, restored and served cached, ``serve(8, 544)`` on
   phase 3's prompts: the same greedy tokens, the SSD scan launched; (e)
   crash consistency: a crash at ``mid_write`` and at ``pre_latest`` of a
   later save into (c)'s directory leaves a restore at the first save, and
   two transient I/O errors are retried away.  Temporary directories,
   removed at the end.
8. serve_pool — the serving front end at full width and depth: (a)
   bert-base (bf16, paged, pages of 16, 8 slots, ``max_len=160``), an
   open-loop ``traffic.replay`` on the wall clock of ``make_trace(32, 8 rps,
   prompts 16..128, 8..32 new)`` three ways (whole-prompt admission with the
   weight cache, ``prefill_chunk=32`` + ``bucket_prompts`` with it,
   whole-prompt factorized): tok/s, p50/p99 latency and TTFT, decode and
   prefill tok/s, occupancy, init seconds, peak memory, launches (flash
   every run, the forward in the factorized one, no plain version), and
   what parked rows add to a decode step (flash over 1 live + 7 parked rows
   against the live row alone, the card's time); (b) float32 bert-base, the
   trace's first 16 requests on a ``VirtualClock``: tokens equal batch-1
   serial generation, a difference allowed only at a serial top-2 margin
   within ``F32_TIE`` of the logits' scale (reported, the request compared
   no further); (c) mamba2-130m, 4 slots, ``max_len=544``, ``make_trace(8,
   4 rps, prompts 64..512, 8..16 new)``: bf16 on the wall clock (24 SSD-scan
   launches an admission, the tied head through the forward), float32 on a
   ``VirtualClock`` under the same token rule; (d) ``serve_fleet(2, 4, 160,
   paged, session_dir=...)`` in float32 on a ``VirtualClock``, fault-free
   (0 trips) and with ``kill-pool:1:10`` (a rebuild, its parameters on the
   card), every request done with the serial tokens; (e) ``flash-raise``:
   a pool step raises ``InjectedKernelError``, no plain version runs.
9. albert — albert-base (bf16, one stored layer run 12 times) at full
   width and depth through phase 6's lifecycle: ``from_dense`` of an exact
   and a truncated tree (errors, Eq. 4 bounds, seconds); 4 LFA steps of the
   ``cls`` task at 16 x 128 (284,020 of 702,836 parameters train, central
   cores unchanged, the cores backward 12 calls a matrix a step); four
   squeeze iterations at phase 6's settings (each event against its float64
   recount, rho falling, no plan lost ``kernel``, the cores backward in the
   re-tunes only); the squeezed model served ``serve(8, 256, paged=True)``
   from 8 x 128 prompts, 32 new tokens, with the weight cache (its W the
   cores' contraction in bf16) and factorized (prefill logits within
   ``PATH_TOL``, flash once a layer a decode step); float32 greedy tokens
   of the squeezed tree identical across paged factorized, paged cached and
   the unpaged cache; the session saved and restored on the card, serving
   the same tokens both ways.
10. llm — gemma2-27b, mistral-nemo-12b, nemotron-4-15b and qwen3-14b, one at
   a time, each freed before the next: the memory of a bf16 cached handle
   reckoned from the shapes first; (a) bf16 at full width and depth,
   ``serve(8, 640, paged=True)`` from 8 x 512 prompts, 16 new tokens, with
   the weight cache (init, ``cache_weights`` seconds and bytes, prefill,
   decode, tok/s, peak memory; flash once a layer a step and no other
   kernel); (a') the same model factorized, the tensor-core forward launched
   exactly as the engine's plans name it, matrix by matrix (at 4 layers);
   (b) float32 at
   full width and 2 layers (gemma2-27b at 1, ``LLM_F32_DEPTH``: one
   4352-token prompt, past its 4096-token window; the others 2 x 128), 16
   new tokens: greedy tokens
   identical across the three runs of phase 4, every step's logits within
   ``f32_tol`` of the teacher-forced forward's on the same tokens, the
   forward kernels the float32 plans name (``csrc/mpo_linear.cu`` at
   gemma2's and nemotron's FFN), and gemma2's w_down (36864 -> 4608)
   through ``csrc/mpo_linear.cu`` against its plain version at M = 64.
   The factorized runs are cut to 4 layers (``LLM_FACT_LAYERS``).
11. ssm_train — the SSM family fine-tuned and squeezed: (a) the SSD scan's
   backward kernel (``csrc/ssd_scan_bwd.cu``, four launches a call) against
   its plain version from the same forward scratch, at mamba2-130m's
   training shape (4 x 512), phase 2's 8 x 512, 8 x 100 and 1 x 4096, with
   a random and a zero final-state cotangent, both dtypes: every gradient
   within ``SSD_BWD_TOL``, two launches bit-identical, the plan's shared
   memory and scratch equal to the CUDA source's; the call, each of its
   launches alone and the plain version timed, with the bound; (b) the
   float32 smoke mamba2-130m with every matmul in the kernel mode: one train
   step's gradients of every leaf and a 3-step loss trajectory on the card
   against the CPU (plain versions) within ``TRAIN_TOL``, the SSD backward
   launched, no plain version; (c) full-width mamba2-130m (bf16) through
   the paper's lifecycle: ``from_dense`` of an exact tree (error <= 1e-4),
   ``finetune(mode="lfa", seq_len=512, batch_size=4, steps=8)`` (finite
   losses, central cores unchanged, 4,015,888 of 6,018,832 parameters
   training, the SSD backward 24 calls a step and its forward 48 (remat),
   both MPO-linear kernels, no plain version; ms a step, peak memory, the
   cores backward's scratch against an f32 dW at every matrix), two calls
   of ``squeeze(step=1, max_iters=1, finetune_steps=4, delta=1.0)`` at 4 x
   512 (each event against its float64 recount, rho falling, no matrix
   losing a ``kernel`` plan, the SSD backward in the re-tunes), the squeezed
   model served ``serve(8, 544)`` both ways from phase 3's prompts under
   phase 3's gates, and a fine-tuning run preempted at step 4 and resumed,
   bit-identical to one run through.
12. moe_vlm — the moe and vlm families at full width (``MOE_ARCHS``; depth
   cut to fit the card, each model freed before the next): (a) the
   MPO-linear forward over an expert stack in one launch, against its plain
   version: llama4-maverick-400b-a17b's w_up (5120 -> 8192, 128 experts) at
   a decode step's and a prefill's capacity rows (32 and 40 an expert) and
   phi3.5-moe's w_up (4096 -> 6400, 16 experts) at 640, both dtypes (the
   tensor-core kernel), smoke phi3.5-moe's experts in float32
   (``csrc/mpo_linear.cu``): within ``TOL``, two launches bit-identical, one
   launch a call, the plan's shared memory and the stack's workspace equal
   to the CUDA source's, each expert's scratch under a quarter of its bf16
   W; kernel, plain, library (``torch.matmul(x, reconstruct_stacked(cores))``)
   and bound; flash at llava-next-34b's geometry (KV 8, G 7, Dh 128), ragged,
   both dtypes; (b) the three smoke models in float32, every matmul in the
   kernel mode, on the card against the CPU; (c) llama4-maverick, bf16,
   ``LLAMA4_FACT_LAYERS`` layers, factorized, ``serve(8, 640, paged=True)``
   from 8 x 512 + 16: the forward launched exactly as the plans name it
   (three stacked launches a MoE layer a call), no plain call; float32 at 1
   layer, every decode step's logits against the teacher-forced forward's
   (at ``capacity_factor`` = E, where no expert overflows); (d) phi3.5-moe,
   bf16, ``PHI35_LAYERS`` layers, the weight cache: the same serve (flash
   once a layer a step, the launches as planned), the same model factorized
   at ``MOE_FACT_LAYERS`` layers (the stacked forward at every expert
   matrix), a pool of 8 slots under
   ``make_trace(32, 2 rps)`` (tok/s, p50/p99 latency and TTFT, occupancy),
   float32 at 2 layers: three runs' tokens identical and a pool on a
   ``VirtualClock`` against serial generation; (e) llava-next-34b, bf16,
   8 x (1024 patches + 512 tokens) in ``serve(8, 1568, paged=True)``, cached
   at the depth its reckoned peak allows (``LLAVA_LAYERS``) and factorized
   at ``MOE_FACT_LAYERS``; float32 at 1 layer (``LLM_F32_DEPTH``) from one
   prompt, three runs' tokens identical.
13. moe_vlm_train — the moe and vlm families fine-tuned: (a) the MPO-linear
   cores backward over an expert stack in one call (one launch set, or one a
   group of experts where the stack's scratch would pass
   ``BWD_STACK_SCRATCH``), against its plain version at phi3.5-moe's w_up
   and w_down (4096 <-> 6400, 16 experts) and llama4-maverick's w_up (5120
   -> 8192, 128 experts) at a 4 x 512 batch's capacity rows (320 and 20 an
   expert), both dtypes: within ``TOL``, two calls bit-identical, each
   expert bit-equal to its matrix run alone, one counted call a call in the
   planned launch sets, the central core skipped, an all-zero expert exactly
   zero, the plan's shared memory and the stack's scratch equal to the CUDA
   source's; kernel, plain, library and bound; (b) the smoke phi3.5-moe,
   llama4-maverick and llava-next-34b in float32, every matmul in the kernel
   mode: one train step's gradients of every leaf and a 3-step loss
   trajectory on the card against the CPU within ``TRAIN_TOL``, the stacked
   backward launched (the moe models), no plain version; (c) full-width
   phi3.5-moe, bf16, ``PHI35_TRAIN_LAYERS`` layers, ``finetune(mode="lfa",
   seq_len=512, batch_size=4, steps=8)``: finite losses and aux, central
   cores unchanged, the reference's trainable count, the stacked forward and
   backward launched exactly as the plans name them, no plain call, ms a
   step, peak memory, the stacked backward's scratch against E float32 dWs;
   then a run preempted at step 4 and resumed, bit-identical to one run
   straight through; (d) full-width llava-next-34b, bf16,
   ``LLAVA_TRAIN_LAYERS`` layers: ``from_dense`` of an exact tree made on the
   card (every matrix's error), 4 LFA steps of 1024 patches + 128 tokens (the
   projector trains, central cores unchanged, the reference's count), one
   ``squeeze`` iteration with a 2-step re-tune (its event against the
   float64 recount, rho falling), the result served both ways under phase
   12 (e)'s gates.
14. hybrid — zamba2-7b (81 Mamba2 blocks in 9 segments, each led by one of
   2 shared attention blocks; weights drawn on the card): (a) its kernels
   against their plain versions at its shapes: the MPO-linear forward at
   in_proj (3584 -> 14576 = 16 x 911, M = 8 and 4096), out_proj and the
   shared w_up (M = 4096), both dtypes, ``csrc/mpo_linear.cu`` at the
   shared wq in float32 (M = 128; the bf16 plan refuses the attention
   matrices), the cores backward at out_proj, w_up and w_down (M = 1024),
   the SSD scan at 8 x 512 and its backward at 2 x 512 (112 heads of 64,
   state 64), both dtypes, each plan's shared memory and scratch against the
   CUDA source's; (b) the smoke model at 6 layers (shared block 0 used
   twice) in float32, every matmul in the kernel mode, card against CPU:
   prefill and decode logits, one train step's gradients, a 3-step loss
   trajectory; (c) bf16 ``serve(8, 544)`` from 8 x 512, 16 new: all 81
   layers with the weight cache (81 SSD-scan launches a prefill), then
   factorized at ``HYB_FACT_LAYERS``, the forward launched exactly as the
   plans name it, no plain call; float32 at ``HYB_F32_LAYERS`` from one
   prompt: the cached and factorized runs' tokens identical, decode logits
   against the teacher-forced forward; (d) ``finetune(mode="lfa",
   seq_len=512, batch_size=2, steps=4)`` at ``HYB_TRAIN_LAYERS``: finite
   losses, central cores unchanged, the reference's count, the cores
   backward at out_proj, w_up and w_down once a use, the SSD backward once
   a layer a step; a run preempted at step 2 and resumed bit for bit at
   ``HYB_LIFE_LAYERS``; (e) at ``HYB_LIFE_LAYERS``: ``from_dense`` of an
   exact tree made on the card, 2 LFA steps, one squeeze iteration against
   its float64 recount, served both ways under (c)'s gates.
15. encdec — whisper-tiny at full width and depth (4 encoder and 4 decoder
   layers, d 384, 1500 stub frames a clip; weights drawn on the card): (a)
   ``csrc/mpo_linear.cu`` in float32 at its attention matrix, w_up and
   w_down (no bf16 route takes them) at M = 8 and 12000 (8 x 1500), the
   cores backward in float32 at M = 3584 (8 x 448) and 12000, the tied head
   on the tensor-core kernel in both dtypes at the rows its paths give it
   (bf16: E^T (384 -> 51968) at M = 8 and 3584, E's own cores (51968 ->
   384, the head's dL/dx) and the cores backward at 3584; float32: the same
   at ``ENC_F32_BATCH`` and ``ENC_F32_BATCH`` x 448): within tolerance of their plain versions, two launches bit-identical,
   each plan's shared memory and scratch against the CUDA source's; (b) the
   smoke model in float32, every matmul in the kernel mode, card against
   CPU: prefill and decode logits, one train step's gradients, a 3-step
   loss trajectory; (c) bf16 ``serve(8, 448)`` from 8 clips and 64-token
   prompts, 32 new, with the weight cache and factorized: the forward
   launched exactly as the plans name it (none in the layers: bf16 has no
   route for whisper's matrices; the factorized tied head once a call), the
   plans' modes listed, no plain call; (d) float32 from ``ENC_F32_BATCH``
   clips both ways: the same tokens, decode logits against the
   teacher-forced forward, ``csrc/mpo_linear.cu`` launched exactly as
   planned (the factorized encoder, and the cross-attention K/V each
   factorized decode step recomputes over the frames); (e)
   ``finetune(mode="lfa", seq_len=448)`` at batch 8 in bf16 and
   ``ENC_F32_BATCH`` in float32, ``ENC_TRAIN_STEPS`` steps: finite losses,
   central cores unchanged, 14,592,960 of 18,860,992 training, the forwards
   and the cores backward exactly as the train plans name them; a float32
   run preempted at step 2 and resumed bit for bit; (f) ``from_dense`` of
   an exact tree made on the card, 2 LFA steps, one squeeze iteration
   against its float64 recount, served both ways under (c)'s gates, saved
   and restored with the same greedy tokens.
16. autotune — the measured plans, from a cold verdict cache in a temporary
   directory (``REPRO_TORCH_AUTOTUNE_CACHE``), measuring at the card's
   default: (a) full-width bert-base (bf16) served factorized,
   ``serve(8, 256, paged=True)`` from phase 3's prompts, 32 new tokens, and
   2 LFA steps at phase 5's 16 x 128, each with the analytic plans and then
   the tuned ones (same weights, same phase): every key raced once, each
   ``kernel@`` candidate launching its kernel (and in ``train`` the cores
   backward), no candidate or run calling a plain version, the runs
   launching exactly what their plans name (the races' launches apart),
   phase 3's gates on the output, tuned against analytic prefill logits
   within ``PATH_TOL``; every verdict with each candidate's ms; prefill ms,
   decode ms a step, LFA ms a step and peak memory both ways; (b) a fresh
   tuner on the same file plans every key alike with no timing; (c) the
   verdicts exported and imported into a second cache, ``Session.save``'s
   ``autotune.json`` and its count, ``Session.restore`` under a fresh tuner
   on an empty cache planning every key alike with no timing,
   ``report()["autotune"]``; (d) mistral-nemo-12b at phase 10's factorized
   depth (``TUNE_LLM_LAYERS``), ``serve(8, 640, paged=True)`` from 8 x 512
   prompts, 16 new, analytic then cold-tuned: the verdicts, prefill and
   decode ms and peak memory both ways, the launches as planned (a record:
   no gate on which candidate wins).  Phases 2-15 run with
   ``REPRO_TORCH_AUTOTUNE_MEASURE=0``: their plans, and the gates that name
   them, are the analytic ones.
17. mesh — the port's mesh path (``parallel.spmd``) on the card, with the
   analytic plans, over a one-rank NCCL world set up in-process and torn
   down at the end: (a) full-width bert-base bf16 ``serve(8, 256,
   paged=True, mesh=make_host_mesh(model=1))`` cached and factorized from
   phase 3's prompts, 32 new tokens: the greedy tokens identical to the
   same calls off the mesh, prefill logits within ``PATH_TOL``, every serve
   and cache leaf a DTensor placed by the rules, the launches those of the
   same calls off the mesh (flash decode, and factorized the MPO-linear
   forward, launched), no plain call, prefill ms, decode ms a step and peak
   memory on and off the mesh; (b) a float32 paged ``serve_pool(8, 160,
   mesh=)`` over ``MESH_POOL_REQUESTS`` of phase 8's trace against batch-1
   serial generation under phase 8's tie rule; (c) ``MESH_TRAIN_STEPS``
   LFA steps at phase 5's 16 x 128 on mesh-placed parameters, plain and
   under ``wrap_compression(kind="int8")``: losses within ``TRAIN_TOL`` of
   the same steps off the mesh, central cores unchanged, the cores backward
   launched as off the mesh; (d) mamba2-130m ``serve(8, 544, mesh=)`` from
   8 x 512 prompts: the tokens and launches (the SSD scan) off the mesh;
   (e) the production rules (FSDP + tensor-parallel) on (2, 4) and (4, 2)
   meshes at bert-base's and qwen3-14b's wq, wk, w_up and w_down, drawn
   alone: each model rank's local cores (cut by the rules' specs, FSDP
   shards gathered as at use) through the MPO-linear forward (bert-base at
   8 and 2048 rows, qwen3-14b at 8: the script passed 1100 s with 2048
   there too) against its plain version — a matrix with no bf16 route is
   recorded, as the engine plans it factorized — the columns (or partial sums) assembled
   against the unsharded kernel, each shard's core shapes, route and ms;
   and flash decode over bert-base's and qwen3-14b's pools split along the
   in-page positions over ``model`` (2 and 4 ranks): each rank's block
   through the kernel with its softmax statistics against its plain
   version, the ranks merged against the unsplit kernel;
   (f) ``launch.train.main(["--arch", "bert-base", "--steps", "3",
   "--compress", "int8"])`` in-process: a finite loss; (g) the moe, vlm,
   hybrid and encdec families at full width, bf16, each call off and on the
   mesh in turns from the same inputs (``MESH_FAM_*``): phi3.5-moe at 2
   layers ``serve(8, 528, paged=True)`` from 8 x 512 prompts, 16 new,
   cached and factorized (the stacked forward over its expert stack), then
   ``MESH_TRAIN_STEPS`` LFA steps at 4 x 512 on mesh-placed parameters;
   llava-next-34b at 2 layers from 8 x (1024 patches + 512 tokens), paged,
   both ways; zamba2-7b at one segment (9 layers) ``serve(8, 528)`` cached
   (the nested ``{"kv", "ssm"}`` cache); whisper-tiny at full depth from 8 x
   (1500 frames + 64 tokens), both ways (``{"self", "enc_out"}``): greedy
   tokens identical and prefill logits bit-equal to the call off the mesh,
   every serve and cache leaf (nested ones too) a DTensor placed by the
   rules, the launches the same as off the mesh with the path's kernels
   launched (flash, the stacked forward, the SSD scan; the stacked cores
   backward in the LFA steps, whose losses are within ``TRAIN_TOL`` and
   central cores unchanged), no plain call; prefill ms, decode ms a step
   and peak GB on and off the mesh; (h) expert-parallel shard shapes, drawn
   alone: phi3.5-moe's and llama4-maverick's w_up and w_down stacks cut by
   the production rules (``"expert": ("model",)``) at model 4 and 2 (4 or 8
   of 16 experts, 32 or 64 of 128): every rank's local stack through the
   stacked forward at a decode's and a prefill's capacity rows against its
   plain version, the ranks' partial combines summed against the unsharded
   kernel's combined output (and each expert's rows against the unsharded
   launch's, bit for bit, recorded), phi3.5's local stack through the cores
   backward at 320 rows an expert; each case's shapes, route, ms, plain ms,
   bound ms and library ms (``torch.matmul`` of the local reconstruction).
   Its launches join the kernels line under ``mesh ...``.  A script can run
   it alone: ``import chip_smoke``, ``repro_torch.kernels._build.build()``,
   set ``REPRO_TORCH_AUTOTUNE_MEASURE=0``, then ``chip_smoke.mesh_phase()``.
18. analysis — the static analysis (``repro_torch.analysis``) and the dry
   run (``launch.dryrun``) against the card.  Their CPU work runs in a
   process of its own at the lowest priority from phase 1's build on, with
   no card visible (``analysis_static``); the phase collects it: (a)
   ``repro-torch-lint``'s sweep — every config at 1x1, 1x4 and 2x4, the
   sharding, kernel and trace families, and the compiler's register report
   of the libraries this run built — with zero errors, and each kernel's
   registers, spill stores and blocks an SM printed; (b)
   ``Session.report()["analysis"]`` of phase 5's full-width bert-base
   session (saved there, restored on the card here): clean, no ``error``
   key, its seconds; (c) the cached and the factorized bert-base decode
   step of ``serve(8, 256, paged=True)`` on the card inside the linter's
   ``HostTransferMode`` and under ``torch.cuda.set_sync_debug_mode("warn")``:
   host syncs, cross-device copies and sync warnings equal to what
   ``trace/host-transfer`` counts for the same step on fake CPU tensors;
   (d) the dry run of bert-base's LFA step at phase 5's 16 x 128 on a
   (1, 1) fake world: its roofline terms and predicted step seconds beside
   the step time phase 5 measured, the prediction at most 1.05x the
   measurement (a floor above the measurement means a wrong count).  A
   script can run it alone: ``import chip_smoke``,
   ``repro_torch.kernels._build.build()``, then
   ``chip_smoke.analysis_phase()``.
19. ``{"kernels": [...]}`` — one entry per kernel and dtype of the paths (the
   squeezed shapes' times are phase 6's records), the stacked forward, the
   stacked cores backward and flash at llava's geometry beside them, the
   hybrid's and the encdec's cases with their launches on their paths
   (phase 16's under ``autotune ...`` keys, the races' own launches apart,
   phase 17's under ``mesh ...``).
20. last line: ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import ctypes
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
BATCH, PROMPT, MAX_LEN, NEW_TOKENS = 8, 128, 256, 32
# kernel vs plain version on the same inputs.  f32: both sum in f32 in
# another order over up to 3072 terms -> relative 1e-4 of the output's
# largest magnitude.  bf16: both round one f32 value to bf16 once, and the
# other summation order can move it across a rounding boundary -> one bf16
# step (2^-8 relative) at the largest output, doubled.
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the two bf16 serving runs round W differently (the cached W is rounded to
# bf16 whole, the kernel rebuilds W in f32 from bf16 cores) and 12 layers
# compound it: prefill logits agree within 5e-2 of their largest magnitude
PATH_TOL = 5e-2
# smoke model on the card vs on the CPU, float32 logits
SMOKE_TOL = 1e-4
# float32 mamba2-130m factorized vs weight-cached, same tokens (phase 4): each
# product lies within 3e-7..2e-6 of float64 in both runs, and 24 layers of
# the randomly drawn model amplify that ~10^3-fold (the bf16 runs' 2^-8
# rounding turns the logits around entirely): 3.1e-3 of their largest
# magnitude measured (5.9e-3 with the float32 forward before it rounded
# each k-step's sum; tools/torch_lifecycle_profile.py); 2^-7 leaves 2.5x
# that and catches any error of bf16 size or a cache that loses its state
F32_TIE = 2.0 ** -7
# fine-tuning (phase 5): full-width bert-base LFA, as the paper trains it
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 128, 8
LFA_COUNTS = (2_629_268, 7_399_060)              # trainable, total (reference's count)
# card vs CPU for the float32 smoke model's train step: both sum in f32 in
# another order, and three AdamW steps compound it -> 1e-4 of each
# gradient's largest magnitude, 1e-4 relative on the losses
TRAIN_TOL = 1e-4
# mamba2-130m serving (phase 3): 8 prompts of 512 tokens = 4 chunks of 128,
# so the carried state crosses three chunk boundaries in every layer
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_MAX_LEN = 8, 512, 544
# the SSD scan's final state against its plain version: f32 sums in another
# order carried across up to 32 chunks -> 1e-4 of its largest magnitude
STATE_TOL = 1e-4
# one bf16 mamba2 block on the card against the same block on the CPU (plain
# versions, every factorized matmul in the kernel mode), same input: the same
# bf16 function summed in another order.  At
# the CPU tests' size that gap is under 5% of the block's bf16-vs-f32 error,
# itself ~2% of the block's update -> 2^-7 of the update's norm (and of the
# f32 state's norm, and of the head's logits) leaves 8x room and still
# catches an extra bf16 rounding anywhere in the block
LAYER_TOL = 2.0 ** -7
# the lifecycle (phase 6): Algorithm 1 on a tree of rank <= the bonds is
# exact up to float32 SVD rounding -> 1e-4 relative; the Eq. 4 bound holds
# with equality in exact arithmetic, so 1 + 1e-4 leaves room for rounding;
# a predicted error against its float64 recount, one layer at a time: 1e-4
LIFE_MAX_LEN, LIFE_STEPS, LIFE_ITERS = 160, 4, 4
EXACT_TOL, EQ4_SLACK, RECOUNT_TOL = 1e-4, 1e-4, 1e-4
# card (cuSOLVER) vs CPU (LAPACK) squeeze of the smoke model: predicted
# errors and reconstructions of every squeezed matrix within 1e-4
CPU_TOL = 1e-4
# the serving front end (phase 8): full-width bert-base pools of 8 slots at
# max_len 160 (prompts of 16..128 tokens, 8..32 new), paged in pages of 16;
# the float32 token gate replays the trace's first 16 requests, the fleet
# has two replicas of 4 slots; mamba2-130m pools of 4 slots at max_len 544
POOL_SLOTS, POOL_MAX_LEN, POOL_PAGE, POOL_REQUESTS, F32_REQUESTS = 8, 160, 16, 32, 16
FLEET_SLOTS, MAMBA_SLOTS = 4, 4
# albert-base (phase 9): the paper's other subject model through phase 6's
# lifecycle and phases 3-4's serving, at bert-base's sizes
ALBERT_LFA_COUNTS = (284_020, 702_836)           # trainable, total (reference's count)
# the dense LLM configurations (phase 10): bf16 at full width and depth from 8
# prompts of 512 tokens, 16 new; float32 at full width and 2 layers, 16 new,
# from 2 prompts of 128 (gemma2-27b: one of 4352, past its 4096-token window);
# gemma2's FFN (csrc/mpo_linear.cu) held against its plain version at M = 64
# and 4352, qwen3-14b's lm_head (the same kernel) at M = 2.  The
# factorized bf16 runs are cut to 4 layers: the forward takes ~140 ms a call
# at mistral's and qwen3's FFN (phase 2's mistral w_up case on an H100), ~17
# s a full-depth prefill (PERF.md); gemma2-27b's and nemotron-4-15b's
# full-depth factorized runs took ~16 and ~13 s with their warm-ups, and with
# them (and zamba2-7b's factorized run at 27 layers) the whole script took
# 904.6-1134.7 s of its 1200 s limit on one H100 host
LLM_ARCHS = ("gemma2-27b", "mistral-nemo-12b", "nemotron-4-15b", "qwen3-14b")
LLM_BATCH, LLM_PROMPT, LLM_MAX_LEN, LLM_NEW = 8, 512, 640, 16
LLM_FACT_LAYERS = {arch: 4 for arch in LLM_ARCHS}
LLM_F32_LAYERS, LLM_F32_NEW, LLM_F32_CASE_M = 2, 16, 64
# depth cuts of the float32 runs whose factorized prefill sends an FFN to
# csrc/mpo_linear.cu: gemma2-27b's 4352 rows took 84.5 s at 2 layers, llava's
# 1152 rows 39.1 s with the kernel's first, CUDA-core design (phase 14's
# time came from these)
LLM_F32_DEPTH = {"gemma2-27b": 1, "llava-next-34b": 1}
LLM_F32_PROMPT, LLM_F32_SHORT = {"gemma2-27b": (1, 4352)}, (2, 128)
# the moe and vlm families (phase 12), weights random from the seed at full
# width, depth cut to fit the card (PERF.md section 4): llama4-maverick-400b-a17b
# factorized at 2 of 48 layers (one layer's 3 x 128 expert matrices are 32.3
# GB of bf16 W, 1.89 GB of f32 cores), float32 at 1 layer; phi3.5-moe-42b-a6.6b
# from the weight cache at 24 of 32 layers (2.60 GB of bf16 W a layer) and
# factorized at 4, a pool
# of 8 slots under make_trace(32, 2 rps) and float32 at 2 layers (its pool
# against serial generation over the trace's first 8 requests);
# llava-next-34b from the weight cache at 60 layers if the reckoned peak stays
# under MOE_PEAK_LIMIT, else 48, and factorized at 4, from 8 x (1024 patches +
# 512 tokens) in serve(8, 1568); the stacked forward timed at STACK_REPS calls
MOE_ARCHS = ("llama4-maverick-400b-a17b", "phi3.5-moe-42b-a6.6b", "llava-next-34b")
LLAMA4, PHI35, LLAVA = MOE_ARCHS
MOE_FACT_LAYERS, PHI35_LAYERS, LLAVA_LAYERS, LLAMA4_F32_NEW = 4, 24, (60, 48), 8
LLAMA4_FACT_LAYERS = 2       # its factorized decode takes ~0.8 s a layer a step
MOE_PEAK_LIMIT, LLAVA_MAX_LEN, STACK_REPS = 78e9, 1568, 3
MOE_POOL_SLOTS, MOE_POOL_MAX_LEN, MOE_POOL_REQUESTS, MOE_POOL_RPS = 8, 544, 32, 2.0
MOE_POOL_VOCAB, MOE_F32_REQUESTS = 32064, 8        # phi3.5-moe's vocabulary before padding
# the moe and vlm families' fine-tuning (phase 13): the stacked cores backward
# at a 4 x 512 batch's capacity rows (phi3.5-moe 320 an expert, llama4 20);
# full-width phi3.5-moe LFA at 2 layers (~52 M MPO parameters a layer, 50 M of
# them experts; ~0.84 s a step at 1 layer on an H100, PERF.md), 8 steps, then
# preempted at step 4 and resumed; full-width llava-next-34b at 2 layers (one
# 7168 x 20480 matrix ~2.7 s through Algorithm 1 on the card, the two 64000 x
# 7168 vocabulary matrices ~3x that each): from_dense, 4 LFA steps of 1024
# patches + 128 tokens, 4 a batch, one squeeze iteration, served both ways
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 4, 512, 8
PHI35_TRAIN_LAYERS, LLAVA_TRAIN_LAYERS = 2, 2
LLAVA_TRAIN_TEXT, LLAVA_TRAIN_BATCH = 128, 4
PHI35_LFA_COUNTS = (71_466_048, 105_217_088)     # trainable, total (reference's count)
LLAVA_LFA_COUNTS = (15_320_900, 28_559_172)      # trainable, total (reference's count)
# the SSM family's fine-tuning (phase 11): full-width mamba2-130m LFA at 4 x
# 512 tokens (4 chunks of 128 a sequence) and its squeeze at the same size
SSM_BATCH, SSM_SEQ, SSM_STEPS = 4, 512, 8
MAMBA_LFA_COUNTS = (4_015_888, 6_018_832)        # trainable, total (reference's count)
# the SSD backward against its plain version.  A float32 gradient (every one
# of the float32 kernel; dt, a_log and D of the bf16 one) sums products of the
# kernel's bf16 terms (three a float32 value, a pair for bf16's f32-valued
# operands: 2^-16) in another order over up to 4096 positions -> 1e-4 of its
# largest magnitude; a bf16 gradient (dx, dB, dC) is one rounding of such a
# sum, which the other order can move across a boundary -> one bf16 step at
# the largest value, doubled
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# the hybrid family (phase 14): zamba2-7b at full width (81 layers in 9
# segments of 9 Mamba2 blocks, 2 shared attention blocks), weights drawn on the
# card from the seed.  bf16 serving from 8 prompts of 512 tokens, 16 new, at
# all 81 layers with the weight cache (~13.5 GB of bf16 W beside ~17.3 GB of
# f32 cores) and factorized at HYB_FACT_LAYERS (one segment; the forward at
# its in_proj takes ~0.3 s a call at 8 x 512, ~23 s of a 27-layer run with
# its warm-up); float32 at HYB_F32_LAYERS (one segment) from one prompt of
# HYB_F32_PROMPT tokens (its attention matrices take csrc/mpo_linear.cu);
# LFA at HYB_TRAIN_LAYERS (3 segments: shared block 0 takes two uses) at 2 x
# 512, preempted and resumed at HYB_LIFE_LAYERS (every save writes the f32
# master weights and AdamW state: ~6 GB a save there, ~17 GB at 27 layers);
# the lifecycle at HYB_LIFE_LAYERS
HYBRID = "zamba2-7b"
HYB_BATCH, HYB_PROMPT, HYB_MAX_LEN, HYB_NEW = 8, 512, 544, 16
HYB_FACT_LAYERS, HYB_F32_LAYERS, HYB_F32_PROMPT, HYB_LIFE_LAYERS = 9, 9, 64, 9
HYB_TRAIN_LAYERS, HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, HYB_TRAIN_STEPS = 27, 2, 512, 4
HYB_LFA_COUNTS = (1_444_506_784, 1_455_971_488)  # at 27 layers: trainable, total (reference's)
# the encdec family (phase 15): whisper-tiny at full width and depth (4
# encoder and 4 decoder layers, d 384; weights drawn on the card from the
# seed): bf16 serve(8, 448) (448: whisper's decoder context) from 8 clips of
# 1500 frames and 64-token prompts, 32 new, both ways; float32 from
# ENC_F32_BATCH clips (its factorized encoder runs csrc/mpo_linear.cu at 2 x
# 1500 rows; 8 x 1500 takes ~4x as long a call); LFA at 8 x 448 in bf16 and
# ENC_F32_BATCH x 448 in float32, ENC_TRAIN_STEPS steps; the lifecycle at
# full depth
ENCDEC = "whisper-tiny"
ENC_BATCH, ENC_PROMPT, ENC_MAX_LEN, ENC_NEW = 8, 64, 448, 32
ENC_F32_BATCH, ENC_TRAIN_STEPS = 2, 4
ENC_LFA_COUNTS = (14_592_960, 18_860_992)        # trainable, total (reference's count)
PEAK_BYTES_S = 3.35e12                           # H100 SXM HBM3
PEAK_OPS_S = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16 / f32 non-tensor


def f32_tol(terms: int, layers: int = 1) -> float:
    """float32 against float32 summed in another order over ``terms`` terms:
    ``TOL``'s 1e-4 is set for 3072, and the rounding of a sum grows as the
    root of its terms, so 1e-4 x sqrt(terms / 3072); each layer of a run
    adds its own.  gemma2-27b's d_ff of 36864 over two layers gives 6.9e-4,
    below the 2^-9 (2.0e-3) one bf16 rounding would add."""
    return TOL["float32"] * math.sqrt(terms / 3072) * layers


def emit(**kw):
    print(json.dumps(kw), flush=True)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---- the lifecycle phase's checks (plain functions on trees; any device) ----


def exact_dense(params: dict) -> dict:
    """A dense tree whose matrices are the reconstructions of ``params``'
    MPO cores, so each has rank <= the bond at every unfolding and Algorithm
    1 recovers it; the other leaves are copied."""
    from repro_torch.core import mpo
    from repro_torch.core.layers import cores_to_list
    if "cores" in params:
        return {"w": mpo.reconstruct_stacked(cores_to_list(params["cores"]))}
    return {k: exact_dense(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in params.items()}


def _at(tree: dict, path) -> dict:
    for k in path:
        tree = tree[k]
    return tree


def eq4_errors(conv_params: dict, dense: dict) -> list[dict]:
    """For every matrix of a truncated conversion, every layer of a stack:
    its relative error and Eq. 4's bound over ||W||_F, from the spectra
    Algorithm 1 sees (``mpo.decompose`` at the converted bonds)."""
    import torch
    from repro_torch.core import mpo
    from repro_torch.core import squeeze as SQ
    from repro_torch.core.layers import cores_to_list
    out = []
    for path, cd in SQ.find_mpo_layers(conv_params).items():
        cores = cores_to_list(cd)
        w = _at(dense, path[:-1])["w"].float()
        keeps = [c.shape[-1] for c in cores[:-1]]
        spec = mpo.MPOSpec(tuple(c.shape[-3] for c in cores), tuple(c.shape[-2] for c in cores),
                           bond_dim=max(keeps))
        _, spectra = mpo.decompose(w, spec)
        wn = torch.linalg.matrix_norm(w)
        err = torch.linalg.matrix_norm(mpo.reconstruct_stacked(cores) - w) / wn
        bound = mpo.total_error_bound(spectra, keeps) / wn
        for e, b in zip(err.reshape(-1).tolist(), bound.reshape(-1).tolist()):
            out.append({"matrix": "/".join(path[:-1]), "rel_err": e, "bound": b})
    return out


def recount_candidates(params: dict) -> list[tuple]:
    """Every squeeze move's Eq. 3 error, counted independently of the
    squeeze's batched sweep: ``bond_spectra`` of each layer alone, in
    float64, combined over a stack as sqrt(sum eps^2).  Returns ``[(eps,
    path, bond, new_dim), ...]``."""
    from repro_torch.core import mpo
    from repro_torch.core import squeeze as SQ
    from repro_torch.core.layers import cores_to_list
    out = []
    for path, cd in SQ.find_mpo_layers(params).items():
        cores = cores_to_list(cd)
        per = ([[c[i] for c in cores] for i in range(cores[0].shape[0])]
               if cores[0].dim() == 5 else [cores])
        spectra = [mpo.bond_spectra([c.double() for c in lc]) for lc in per]
        for k, c in enumerate(cores[:-1]):
            new = min(c.shape[-1], spectra[0][k].shape[-1]) - 1
            if new < 1:
                continue
            eps = sum(float((s[k][new:] ** 2).sum()) for s in spectra) ** 0.5
            out.append((eps, path, k, new))
    return out


def check_event(ev, pre_params: dict) -> dict:
    """An event's predicted error against the recount of the tree it was
    chosen from, and its bond an argmin of the recount (within
    ``RECOUNT_TOL``: the float32 sweep and the float64 recount round
    differently)."""
    cands = recount_candidates(pre_params)
    best = min(cands, key=lambda c: c[0])
    mine = [c for c in cands if (c[1], c[2]) == (tuple(ev.layer), ev.bond)]
    if len(mine) != 1 or mine[0][3] != ev.new_dim:
        fail(f"squeeze event {ev.step}: {ev.layer} bond {ev.bond} -> {ev.new_dim} is not a "
             f"candidate of the tree it was chosen from")
    eps = mine[0][0]
    if not abs(ev.predicted_error - eps) <= RECOUNT_TOL * eps:
        fail(f"squeeze event {ev.step}: predicted error {ev.predicted_error}, recount {eps}")
    if not eps <= best[0] * (1 + RECOUNT_TOL):
        fail(f"squeeze event {ev.step}: chose {ev.layer} bond {ev.bond} (eps {eps}), the "
             f"recount's least is {best[1]} bond {best[2]} (eps {best[0]})")
    second = min((c[0] for c in cands if c is not best), default=float("inf"))
    return {"recount": eps, "least": best[0], "runner_up": second,
            "gap": (second - best[0]) / best[0]}


def planned_modes(engine, params: dict, train_tokens: int, prefill_tokens: int,
                  batch: int) -> dict:
    """{(matrix, use): mode} of the bf16 plans the card makes for each
    factorized matrix where the lifecycle runs it: the layers' matrices in
    training, prefill and factorized decode (re-planned as a prefill of
    ``batch`` rows), the tied head E^T in a prefill's last position."""
    from repro_torch.core import mpo
    from repro_torch.core import squeeze as SQ
    from repro_torch.core.layers import cores_to_list
    out = {}
    for path, cd in SQ.find_mpo_layers(params).items():
        cores = [c[0] if c.dim() == 5 else c for c in cores_to_list(cd)]
        name = "/".join(path[:-1])
        plan = lambda sh, m, ph: engine.plan(tuple(tuple(c.shape) for c in sh), m, ph,
                                             "bfloat16", "cuda").mode
        if path[0] == "embed":
            out[(name, "prefill head")] = plan(mpo.transpose_cores(cores), batch, "prefill")
        else:
            out[(name, "train")] = plan(cores, train_tokens, "train")
            out[(name, "prefill")] = plan(cores, prefill_tokens, "prefill")
            out[(name, "decode factorized")] = plan(cores, batch, "prefill")
    return out


FWD_KERNEL = {"mma": "mpo_linear_fwd_mma", "cuda_core": "mpo_linear_fwd"}   # forward_kernel's routes


def path_rows(path, cfg, batch: int, tokens: int) -> int:
    """The rows a layer matrix multiplies for ``batch`` x ``tokens`` decoder
    tokens: an encdec model's encoder matrices and cross-attention K/V
    projections take the frames (``batch * frontend_len``), every other
    matrix a row a token."""
    if cfg.family == "encdec" and (path[0] == "encoder" or
                                   (path[1] == "xattn" and path[2] in ("wk", "wv"))):
        return batch * cfg.frontend_len
    return batch * tokens


def serve_plan(engine, params: dict, cfg, batch: int, prompt: int,
               dtype: str, weight_cache: bool = False) -> tuple[dict, dict]:
    """How the engine plans a factorized serving run on the card (``linear``'s
    rules): each layer matrix at a prefill's ``batch * prompt`` rows (a
    VLM's ``prompt`` counts its patches; ``path_rows`` gives an encdec
    model's encoder and cross-attention K/V the frames' rows, and a decode
    step recomputes those K/V from the stored encoder output), an expert
    matrix at its capacity rows an expert (``batch * cap``, ``cap`` of the
    prompt's length in prefill, of one token in decode; the whole stack one
    launch), the head (E^T when ``tied``, else ``lm_head``) at the prefill's
    last position (``batch`` rows), and in decode the ``cached`` plan re-made
    as a prefill of the decode's rows (raw cores); an encoder runs in the
    prefill only.  Returns ``({matrix: {"prefill": mode, "decode": mode}},
    {kernel: [launches a prefill, launches a decode step]})`` with the
    kernel ``mpo_linear`` routes each ``kernel`` plan to, an expert stack's
    launches counted again under ``kernel + "_stacked"``; a layer matrix runs
    once a layer (``num_layers`` times for the one stored layer of
    ``share_layers``, ``num_enc_layers`` for an encoder's), a hybrid's shared
    block once a segment.  With ``weight_cache`` the matrices
    ``cache_weights`` contracts (decode plan ``cached`` at one token) run
    their dense W and are left out."""
    from repro_torch.core import squeeze as SQ
    from repro_torch.core.layers import cores_to_list
    from repro_torch.kernels import mpo_linear as MK
    modes, launches = {}, {}
    for path, cd in SQ.find_mpo_layers(params).items():
        cores = cores_to_list(cd)
        shapes = tuple(tuple(c.shape[-4:]) for c in cores)
        if weight_cache and engine.plan(shapes, 1, "decode").mode == "cached":
            continue
        if path[0] == "embed":
            if not cfg.tie_embeddings:
                continue                     # looked up, never multiplied
            shapes = tuple((d0, j, i, d1) for d0, i, j, d1 in shapes)      # E^T
        head = path[0] in ("embed", "lm_head")
        encoder = cfg.family == "encdec" and path[0] == "encoder"
        if "experts" in path:
            cap = lambda s: max(4, int(cfg.capacity_factor * s * cfg.top_k / cfg.num_experts))
            rows, dec_rows = batch * cap(prompt), batch * cap(1)
        elif head:
            rows, dec_rows = batch, batch
        else:
            rows = path_rows(path, cfg, batch, prompt)
            dec_rows = None if encoder else path_rows(path, cfg, batch, 1)
        plan = lambda m, ph: engine.plan(shapes, m, ph, dtype, "cuda").mode
        use = {"prefill": plan(rows, "prefill")}
        if dec_rows is not None:
            dec = plan(dec_rows, "decode")
            use["decode"] = plan(dec_rows, "prefill") if dec == "cached" else dec
        modes["/".join(path[:-1])] = use
        route = FWD_KERNEL.get(MK.forward_kernel(shapes, dtype))
        # a hybrid's shared blocks run once a segment that takes them
        uses = (1 if head else cfg.num_enc_layers if encoder
                else cfg.num_layers // cfg.attn_every if path[0] == "shared_attn"
                else cfg.num_layers)
        for k, ph in enumerate(("prefill", "decode")):
            if use.get(ph) == "kernel":
                for key in (route, route + "_stacked") if "experts" in path else (route,):
                    launches.setdefault(key, [0, 0])[k] += uses
    return modes, launches


def encdec_train_launches(engine, params: dict, cfg, batch: int, seq: int, dtype: str,
                          steps: int, tied_head: bool = True) -> tuple[dict, dict]:
    """The kernel launches ``steps`` whisper fine-tuning steps of ``batch``
    x ``seq`` decoder tokens make where the train plan names the kernel:
    each use of such a matrix runs its forward once (twice in a layer that
    ``cfg.remat`` recomputes in the backward), its dL/dx over the
    i/j-swapped cores once and the cores backward once; the tied head E^T
    at every decoder position (none without ``tied_head``: a ``cls`` task
    only looks the embedding up).  Returns ``({matrix: uses a step},
    {kernel: launches})``."""
    from repro_torch.core import squeeze as SQ
    from repro_torch.core.layers import cores_to_list
    from repro_torch.kernels import mpo_linear as MK
    planned, want = {}, {}
    for path, cd in SQ.find_mpo_layers(params).items():
        shapes = tuple(tuple(c.shape[-4:]) for c in cores_to_list(cd))
        if path[0] == "embed":
            if not tied_head:
                continue
            shapes = tuple((d0, j, i, d1) for d0, i, j, d1 in shapes)      # E^T
            rows, uses, again = batch * seq, 1, 0
        else:
            rows = path_rows(path, cfg, batch, seq)
            uses = cfg.num_enc_layers if path[0] == "encoder" else cfg.num_layers
            again = int(cfg.remat)
        if engine.plan(shapes, rows, "train", dtype, "cuda").mode != "kernel":
            continue
        planned["/".join(path[:-1])] = uses
        swap = tuple((d0, j, i, d1) for d0, i, j, d1 in shapes)
        for key, n in ((FWD_KERNEL[MK.forward_kernel(shapes, dtype)], uses * (1 + again)),
                       (FWD_KERNEL[MK.forward_kernel(swap, dtype)], uses),
                       ("mpo_linear_bwd_cores", uses)):
            want[key] = want.get(key, 0) + n * steps
    return planned, want


# the autotune phase (16): full-width bert-base, bf16, served from phase 3's
# prompts and fine-tuned at phase 5's batch; mistral-nemo-12b at phase 10's
# factorized depth from 8 x 512 prompts.  The tuner measures by default on
# the card; phases 2-15 run with REPRO_TORCH_AUTOTUNE_MEASURE=0
TUNE_LFA_STEPS, TUNE_PREFILLS = 2, 2         # LFA steps a run; prefills timed a run
# each comparison runs in turns: analytic, tuned (the first: from a cold
# cache, its races inside), tuned, analytic
TUNE_TURNS = (False, True, True, False)
TUNE_LLM, TUNE_LLM_LAYERS = "mistral-nemo-12b", 4


def autotune_phase() -> dict:
    """16. autotune — the measured plans on the card, from a cold cache in a
    temporary directory.  Returns ``{kernel: {path: launches}}`` of the
    planned launches of its runs (the races' own launches apart)."""
    import numpy as np
    import torch

    from repro_torch import Session
    from repro_torch.core import engine as E
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import mpo_linear as MK

    t_phase = time.perf_counter()
    watched = ((MK.mpo_linear_mma, "launches"), (MK.mpo_linear_cuda_core, "launches"),
               (MK.mpo_linear_bwd_cores, "launches"), (DA.flash_decode_attention, "launches"),
               (MK.mpo_linear_plain, "calls"), (MK.mpo_linear_bwd_cores_plain, "calls"),
               (DA.flash_decode_attention_plain, "calls"))
    names = ("mpo_linear_fwd_mma", "mpo_linear_fwd", "mpo_linear_bwd_cores",
             "flash_decode_attention", "mpo_linear_plain", "mpo_linear_bwd_cores_plain",
             "flash_decode_attention_plain")
    plains = names[4:]

    def counts():
        return {n: getattr(fn, attr) for n, (fn, attr) in zip(names, watched)}

    def zero():
        for fn, attr in watched:
            setattr(fn, attr, 0)

    # every race of the phase goes through this wrapper of the tuner's
    # candidates: a key is measured at most once, each kernel@ candidate
    # launches its kernel (and, in train, the cores backward), no candidate
    # calls a plain version; the races' launches are summed apart
    races, race_launches = {}, {n: 0 for n in names}
    build = AT._candidates

    def watch(key, label, thunk):
        def run():
            before = counts()
            out = thunk()
            torch.cuda.synchronize()
            after = counts()
            d = {n: after[n] - before[n] for n in names}
            for n in names:
                race_launches[n] += d[n]
            if any(d[n] for n in plains):
                fail(f"autotune: candidate {label} of {key} called a plain version: {d}")
            if label.startswith("kernel@"):
                need = [n for n in ("mpo_linear_fwd_mma", "mpo_linear_fwd") if d[n]]
                if not need or (races[key]["phase"] == "train" and not d["mpo_linear_bwd_cores"]):
                    fail(f"autotune: candidate {label} of {key} did not launch its kernel: {d}")
                races[key]["kernel_launches"][label] = races[key]["kernel_launches"].get(
                    label, 0) + sum(d[n] for n in names[:3])
            return out
        return run

    def plan_vs_source(shapes, m, dtype, bm):
        """The tile's plan against the CUDA source's shared memory and
        workspace, where the kernel takes the tile."""
        plan = MK.forward_plan(shapes, m, dtype, bm)
        if plan is None:
            return
        dims, n = MK._dims(shapes), len(shapes)
        if MK.forward_kernel(shapes, dtype) == "mma":
            code = MK.DTYPES[getattr(torch, dtype)]
            got = (MK._mma_lib().mpo_linear_mma_smem(dims, n, plan.split, bm, code),
                   4 * MK._mma_lib().mpo_linear_mma_workspace(dims, n, plan.split, m,
                                                              plan.splits, 1, code))
        else:
            got = (MK._lib().mpo_linear_fwd_smem(dims, n, plan.split, bm, plan.ch, plan.lq),
                   MK._lib().mpo_linear_fwd_workspace(dims, n, plan.split, m, plan.splits, 1))
        if got != (plan.smem, plan.workspace):
            fail(f"autotune: the plan of {shapes} at {m} rows, tile {bm}: shared memory / "
                 f"workspace {plan.smem} / {plan.workspace}, the CUDA source's {got}")

    def candidates(shapes, tokens, phase, dtype, device):
        key = AT.make_key(shapes, tokens, phase, dtype, device)
        if key in races:
            fail(f"autotune: key measured twice: {key}")
        races[key] = {"shapes": [list(c) for c in shapes], "tokens": tokens, "phase": phase,
                      "dtype": dtype, "kernel_launches": {}}
        out = build(shapes, tokens, phase, dtype, device)
        for label, _ in out:
            if label.startswith("kernel@"):
                bm = int(label.split("@")[1])
                plan_vs_source(shapes, tokens, dtype, bm)
                if phase == "train":             # dL/dx at the tile where it is taken
                    plan_vs_source(tuple((a, j, i, b) for a, i, j, b in shapes), tokens,
                                   dtype, bm)
        return [(label, watch(key, label, thunk)) for label, thunk in out]

    def analytic(on: bool):
        """Measuring off (``on`` False) or the card's default (measuring)."""
        if on:
            os.environ.pop(AT.ENV_MEASURE, None)
        else:
            os.environ[AT.ENV_MEASURE] = "0"
        E.clear_plan_cache()

    def verdicts(tuner, what):
        """Every verdict in the tuner's cache file, each candidate's ms."""
        out = []
        for key, ent in json.load(open(tuner.path))["entries"].items():
            out.append(dict(key=key.split("|shapes=")[1], mode=ent["mode"],
                            block_m=ent["block_m"],
                            timings_ms={k: 1e3 * v for k, v in sorted(
                                ent["timings"].items(), key=lambda kv: kv[1])},
                            kernel_launches=races.get(key, {}).get("kernel_launches", {})))
        emit(phase="autotune", step="verdicts", what=what, substrate=AT.substrate("cuda"),
             verdicts=out)

    def plans_of(engine):
        """{key: (mode, block_m)} re-planned for every raced key."""
        return {k: (p.mode, p.block_m) for k, p in (
            (k, engine.plan(r["shapes"], r["tokens"], r["phase"], r["dtype"], "cuda"))
            for k, r in races.items())}

    def serve_timed(sess, what, ps, max_len, new_tokens, planned):
        """Warm-up, then ``TUNE_PREFILLS`` prefills (the least time kept) and
        ``new_tokens`` - 1 decode steps timed on the wall clock to
        ``synchronize``, the launches zeroed just before the prefills and
        the decode and read just after each, held to ``planned`` ({kernel:
        [a prefill, a decode step]}); returns the record and the prefill
        logits."""
        handle = sess.serve(len(ps), max_len, paged=True, weight_cache=False)
        handle.generate({"tokens": ps}, 2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        prefill_ms = []
        for _ in range(TUNE_PREFILLS):
            handle.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = handle.prefill({"tokens": ps})
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            prefill_ms.append(1e3 * (t1 - t0))
        pre = counts()
        zero()
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out, finite = [tok], bool(torch.isfinite(logits).all())
        for _ in range(new_tokens - 1):
            tok, step_logits = handle.decode(tok)
            out.append(tok)
            finite &= bool(torch.isfinite(step_logits).all())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dec = counts()
        n_dec = new_tokens - 1
        rec = dict(prefill_ms=min(prefill_ms), prefill_ms_runs=prefill_ms,
                   decode_ms_per_step=1e3 * (t2 - t1) / n_dec,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   launches_in_prefills={k: pre[k] for k in names[:4]},
                   launches_in_decode={k: dec[k] for k in names[:4]})
        tokens = torch.cat(out, 1)
        if not finite or tuple(tokens.shape) != (len(ps), new_tokens):
            fail(f"autotune {what}: non-finite logits or tokens of shape {tuple(tokens.shape)}")
        if any(pre[k] or dec[k] for k in plains) or pre["mpo_linear_fwd"] or \
                dec["mpo_linear_fwd"]:
            fail(f"autotune {what}: a plain version or csrc/mpo_linear.cu ran on the bf16 "
                 f"path: {pre} {dec}")
        want_pre = {k: v[0] * TUNE_PREFILLS for k, v in planned.items()}
        want_dec = {k: v[1] * n_dec for k, v in planned.items()}
        if pre["mpo_linear_fwd_mma"] != want_pre.get("mpo_linear_fwd_mma", 0) or \
                dec["mpo_linear_fwd_mma"] != want_dec.get("mpo_linear_fwd_mma", 0):
            fail(f"autotune {what}: the forward launched {pre['mpo_linear_fwd_mma']} in "
                 f"{TUNE_PREFILLS} prefills and {dec['mpo_linear_fwd_mma']} in decode, the "
                 f"plans name {want_pre} / {want_dec}")
        sess._serve.clear()
        return rec, logits.float()

    def serve_turns(sess, arch, ps, max_len, new_tokens, batch, prompt):
        """``serve_timed`` in ``TUNE_TURNS``, the plans each turn names held
        to its launches (``serve_plan``; planning the cold turn races its
        keys); the tuned turns' prefill logits within ``PATH_TOL`` of the
        analytic ones'.  Returns {side: summary}."""
        recs, logits = {}, {}
        for n, on in enumerate(TUNE_TURNS):
            analytic(on)
            cold = on and not any(TUNE_TURNS[:n])
            if cold and (not AT.should_measure("cuda") or AT.get_tuner().timing_runs):
                fail("autotune: the tuner does not measure by default on the card, or the "
                     "cache was not cold")
            side = "tuned" if on else "analytic"
            runs0, race0 = AT.get_tuner().timing_runs, dict(race_launches)
            t0 = time.perf_counter()
            modes, planned = serve_plan(sess.engine, sess.params, sess.cfg, batch, prompt,
                                        "bfloat16")
            planning_s = time.perf_counter() - t0
            if not cold and AT.get_tuner().timing_runs != runs0:
                fail(f"autotune {arch} {side} turn {n + 1}: planning measured again")
            what = f"{arch} serve {side} (turn {n + 1})"
            rec, logits[on] = serve_timed(sess, what, ps, max_len, new_tokens, planned)
            rec.update(modes=modes, planning_s=planning_s, timing_runs=AT.get_tuner().timing_runs,
                       keys_raced=len(races),
                       race_launches={k: race_launches[k] - race0[k] for k in names[:3]})
            recs.setdefault(side, []).append(rec)
            for k in ("mpo_linear_fwd_mma", "flash_decode_attention"):
                cell = by_path.setdefault(k, {})
                cell[f"{arch} serve {side}"] = cell.get(f"{arch} serve {side}", 0) + (
                    rec["launches_in_prefills"][k] + rec["launches_in_decode"][k])
            emit(phase="autotune", step=what, arch=arch, batch=batch, prompt=prompt,
                 new_tokens=new_tokens, **rec)
            if on:
                diff = (logits[True] - logits[False]).abs().max().item()
                scale = logits[False].abs().max().item()
                if diff > PATH_TOL * scale:
                    fail(f"autotune {what}: prefill logits differ from the analytic ones' by "
                         f"{diff} > {PATH_TOL} x {scale}")
        out = {side: dict(prefill_ms=min(min(r["prefill_ms_runs"]) for r in rs),
                          decode_ms_per_step=sum(r["decode_ms_per_step"] for r in rs) / len(rs),
                          peak_mem_bytes=max(r["peak_mem_bytes"] for r in rs),
                          turns=len(rs)) for side, rs in recs.items()}
        emit(phase="autotune", step=f"{arch} serve, tuned against analytic", **out,
             prefill_logits_max_abs_diff=diff, scale=scale, tol=PATH_TOL)
        return out

    def lfa_timed(sess, what, want, steps):
        """``steps`` LFA steps at phase 5's batch from the weights in
        ``start`` (every run from the same ones), launches zeroed just before
        and read just after; with ``want`` ({kernel: launches} the train plans
        name), the races' launches taken out, held to it."""
        with torch.no_grad():
            for k, v in sess.model.state_dict().items():
                v.copy_(start[k])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero()
        race0 = dict(race_launches)
        t0 = time.perf_counter()
        rep = sess.finetune(steps=steps, seed=SEED, mode="lfa", seq_len=TRAIN_SEQ,
                            batch_size=TRAIN_BATCH, log_every=1)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = counts()
        path = {k: got[k] - (race_launches[k] - race0[k]) for k in names}
        losses = [h["loss"] for h in rep["history"]]
        if len(losses) != steps or not all(math.isfinite(v) for v in losses):
            fail(f"autotune {what}: losses {losses}")
        if any(path[k] for k in plains) or path["mpo_linear_fwd"]:
            fail(f"autotune {what}: a plain version or csrc/mpo_linear.cu ran: {path}")
        if want is not None and any(path[k] != want.get(k, 0) for k in names[:3]):
            fail(f"autotune {what}: launched {path}, the train plans name {want}")
        return dict(ms_per_step=1e3 * sec / steps, peak_mem_bytes=torch.cuda.max_memory_allocated(),
                    losses=losses, launches={k: path[k] for k in names[:3]},
                    race_launches={k: race_launches[k] - race0[k] for k in names[:3]})

    by_path = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_autotune_"))
    AT._candidates = candidates
    try:
        os.environ[AT.ENV_CACHE] = str(tmp / "cache.json")
        tuner = AT.reset_tuner()
        # (a) full-width bert-base, bf16, factorized: analytic and measured
        # plans in turns, serving and then LFA (its cls task: no vocabulary
        # head in training)
        sess = Session.init("bert-base", smoke=False, seed=SEED)
        cfg, eng = sess.cfg, sess.engine
        prompts = np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)      # phase 3's
        runs = {"bert-base serve": serve_turns(sess, "bert-base", prompts, MAX_LEN, NEW_TOKENS,
                                               BATCH, PROMPT)}
        serve_keys = len(races)
        start = {k: v.clone() for k, v in sess.model.state_dict().items()}
        analytic(False)
        lfa_timed(sess, "bert-base finetune lfa (warm-up)", None, 1)
        lfa = {}
        for n, on in enumerate(TUNE_TURNS):
            analytic(on)
            cold = on and not any(TUNE_TURNS[:n])
            side = "tuned" if on else "analytic"
            what = f"bert-base finetune lfa {side} (turn {n + 1})"
            plans = lambda: encdec_train_launches(eng, sess.params, cfg, TRAIN_BATCH, TRAIN_SEQ,
                                                  "bfloat16", TUNE_LFA_STEPS,
                                                  tied_head=sess.task == "lm")[1]
            want = None if cold else plans()
            rec = lfa_timed(sess, what, want, TUNE_LFA_STEPS)
            if cold:          # the races ran inside; the plans they made, after
                want = plans()
                if any(rec["launches"][k] != want.get(k, 0) for k in rec["launches"]):
                    fail(f"autotune {what}: launched {rec['launches']} besides the races, "
                         f"the train plans name {want}")
            rec["train_plans"] = want
            lfa.setdefault(side, []).append(rec)
            # one function of the same weights: the first step's loss within
            # phase 3's tolerance of the analytic run's
            base = lfa["analytic"][0]["losses"][0]
            if not abs(rec["losses"][0] - base) <= PATH_TOL * abs(base):
                fail(f"autotune {what}: the first step's loss {rec['losses'][0]} is not "
                     f"within {PATH_TOL} of the analytic run's {base}")
            for k in ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"):
                cell = by_path.setdefault(k, {})
                cell[f"bert-base finetune lfa {side}"] = (
                    cell.get(f"bert-base finetune lfa {side}", 0) + rec["launches"][k])
            emit(phase="autotune", step=what, arch="bert-base", batch=TRAIN_BATCH,
                 seq_len=TRAIN_SEQ, steps=TUNE_LFA_STEPS, cold=cold, **rec)
        runs["bert-base finetune lfa"] = {
            side: dict(ms_per_step=[r["ms_per_step"] for r in rs],
                       peak_mem_bytes=max(r["peak_mem_bytes"] for r in rs))
            for side, rs in lfa.items()}
        tuner = AT.get_tuner()
        analytic(True)                      # the turns ended on the analytic plans
        verdicts(tuner, "bert-base")
        entries = json.load(open(tmp / "cache.json"))["entries"]
        if not len(races) == len(entries) == tuner.stats()["keys_resolved"] or \
                set(races) != set(entries):
            fail(f"autotune: {len(races)} keys raced, {tuner.stats()['keys_resolved']} "
                 f"resolved, {len(entries)} in the cache file")
        measured_plans = plans_of(eng)
        emit(phase="autotune", step="bert-base raced", keys=len(races), serve_keys=serve_keys,
             train_keys=len(races) - serve_keys, timing_runs=tuner.timing_runs,
             race_launches=dict(race_launches), cache_entries=len(entries))
        # (b) a fresh tuner on the same file: the same plans, no timing
        tuner = AT.reset_tuner()
        analytic(True)
        if plans_of(eng) != measured_plans or tuner.timing_runs:
            fail(f"autotune: a fresh tuner planned {plans_of(eng)} with {tuner.timing_runs} "
                 f"timing runs, the measuring one {measured_plans}")
        emit(phase="autotune", step="fresh tuner, same file", keys=len(measured_plans),
             timing_runs=tuner.timing_runs, identical=True)
        # (c) shipped and restored: export, import into a second cache; the
        # session saved (autotune.json) and restored under a fresh tuner on
        # an empty cache
        shipped = AT.export_cache(str(tmp / "ship" / "verdicts.json"))
        os.environ[AT.ENV_CACHE] = str(tmp / "second.json")
        AT.reset_tuner()
        got = AT.import_cache(shipped["path"])
        second = json.load(open(tmp / "second.json"))["entries"]
        if shipped["exported"] != len(entries) or got["imported"] != len(entries) or \
                second != entries:
            fail(f"autotune: exported {shipped}, imported {got}: not the same verdicts")
        t0 = time.perf_counter()
        sess.save(str(tmp / "session"))
        save_s = time.perf_counter() - t0
        manifest = json.load(open(tmp / "session" / "session.json"))
        saved = json.load(open(tmp / "session" / "autotune.json"))["entries"]
        if manifest["autotune_entries"] != len(saved) or saved != entries:
            fail(f"autotune: Session.save wrote {len(saved)} verdicts, counted "
                 f"{manifest['autotune_entries']}, measured {len(entries)}")
        os.environ[AT.ENV_CACHE] = str(tmp / "third.json")
        tuner = AT.reset_tuner()
        analytic(True)
        t0 = time.perf_counter()
        restored = Session.restore(str(tmp / "session"))
        restore_s = time.perf_counter() - t0
        again = plans_of(restored.engine)
        report = restored.report().get("autotune")
        if again != measured_plans or tuner.timing_runs or report is None or \
                report["keys_resolved"] != len(entries):
            fail(f"autotune: the restored session planned with {tuner.timing_runs} timing "
                 f"runs, report {report}")
        emit(phase="autotune", step="shipped and restored", exported=shipped["exported"],
             imported=got["imported"], autotune_entries=manifest["autotune_entries"],
             save_s=save_s, restore_s=restore_s, restored_timing_runs=tuner.timing_runs,
             report=report, identical=True)
        del sess, restored
        torch.cuda.empty_cache()

        # (d) mistral-nemo-12b at phase 10's factorized depth: cold-tuned,
        # recorded beside the analytic plans (no gate on which mode wins)
        from repro_torch import configs
        os.environ[AT.ENV_CACHE] = str(tmp / "llm.json")
        tuner = AT.reset_tuner()
        lcfg = dataclasses.replace(configs.get_config(TUNE_LLM), num_layers=TUNE_LLM_LAYERS)
        lsess = Session.init(lcfg, seed=SEED)
        lprompts = np.random.default_rng(SEED + 10).integers(
            0, lcfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)
        races.clear()                       # a new cache: its keys raced anew
        llm = f"{TUNE_LLM} ({TUNE_LLM_LAYERS} layers)"
        runs[f"{llm} serve"] = serve_turns(lsess, llm, lprompts, LLM_MAX_LEN, LLM_NEW,
                                           LLM_BATCH, LLM_PROMPT)
        verdicts(tuner, TUNE_LLM)
        emit(phase="autotune", step=f"{TUNE_LLM} raced", keys=len(races),
             timing_runs=tuner.timing_runs, race_launches=dict(race_launches))
        del lsess
        torch.cuda.empty_cache()
    finally:
        AT._candidates = build
        os.environ[AT.ENV_MEASURE] = "0"
        os.environ.pop(AT.ENV_CACHE, None)
        E.clear_plan_cache()
        AT.reset_tuner()
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="autotune", s=time.perf_counter() - t_phase, summary=runs)
    return by_path


# the mesh phase (17): one card is a mesh of (1, 1) over a one-rank NCCL
# world set up in-process; the shard shapes of (2, 4) and (4, 2) meshes are
# emulated rank by rank.  MESH_TRAIN_STEPS LFA steps at phase 5's batch;
# MESH_POOL_REQUESTS of phase 8's trace through a float32 pool.
MESH_TRAIN_STEPS, MESH_POOL_REQUESTS = 2, 16
MESH_EMULATED = ((2, 4), (4, 2))
# the rows each arch's shards run at: qwen3-14b's at 8 only, as the whole
# script passed 1100 s of its 1200 s with 2048 there too
MESH_ROWS = {"bert-base": (8, 2048), "qwen3-14b": (8,)}
# (g): the moe, vlm, hybrid and encdec families on the (1, 1) mesh at full
# width, bf16, depth cut to these layers (whisper-tiny at its full 4): 8
# prompts of 512 tokens (llava: behind 1024 patches; whisper-tiny: 64 behind
# 1500 frames), 16 new tokens; phi3.5-moe's LFA at phase 13's batch
MESH_FAM_LAYERS = {"phi3.5-moe-42b-a6.6b": 2, "llava-next-34b": 2, "zamba2-7b": 9}
MESH_FAM_BATCH, MESH_FAM_PROMPT, MESH_FAM_MAX_LEN, MESH_FAM_NEW = 8, 512, 528, 16
# (h): the model axes the expert stacks are cut for
MESH_EP_MODEL = (4, 2)


def mesh_phase() -> dict:
    """17. mesh — the port's mesh path on the card (``parallel.spmd``):
    (a) full-width bert-base bf16 served on ``make_host_mesh(model=1)``,
    paged, cached and factorized, against the same calls off the mesh; (b) a
    float32 paged pool on the mesh against batch-1 serial generation; (c)
    LFA steps on mesh-placed parameters, plain and under int8 EF
    compression, against the same steps off the mesh; (d) mamba2-130m served
    on the mesh; (e) the MPO-linear forward on every shard shape the
    production rules give (2, 4) and (4, 2) meshes at bert-base's and
    qwen3-14b's layer matrices, each rank's shard against its plain version
    and the assembled result against the unsharded kernel; (f)
    ``launch.train.main`` in-process; (g) phi3.5-moe, llava-next-34b,
    zamba2-7b and whisper-tiny at full width, cut depth, on and off the
    mesh; (h) the expert-parallel shards of phi3.5-moe's and
    llama4-maverick's stacks at model 4 and 2.  Runs with the analytic
    plans.  Returns ``{kernel: {path: launches}}`` of its paths."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import Session, configs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import engine as E
    from repro_torch.core import layers as L
    from repro_torch.core import lightweight, mpo
    from repro_torch.data.pipeline import make_batch_fn
    from repro_torch.kernels import autotune as AT
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import mpo_linear as MK
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train as LT
    from repro_torch.models.model import build
    from repro_torch.optim import optimizers
    from repro_torch.optim.compress import wrap_compression
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import spmd
    from repro_torch.pipeline import traffic as TRF
    from repro_torch.pipeline.clock import VirtualClock
    from repro_torch.timing import device_ms
    from repro_torch.train.steps import TrainState, make_train_step

    t_phase = time.perf_counter()
    os.environ[AT.ENV_MEASURE] = "0"
    E.clear_plan_cache()
    AT.reset_tuner()
    watched = {"mpo_linear_fwd_mma": (MK.mpo_linear_mma, "launches"),
               "mpo_linear_fwd": (MK.mpo_linear_cuda_core, "launches"),
               "mpo_linear_bwd_cores": (MK.mpo_linear_bwd_cores, "launches"),
               "mpo_linear_fwd_mma_stacked": (MK.mpo_linear_mma, "stacked_launches"),
               "mpo_linear_bwd_cores_stacked": (MK.mpo_linear_bwd_cores, "stacked_launches"),
               "flash_decode_attention": (DA.flash_decode_attention, "launches"),
               "ssd_scan": (SSD.ssd_scan, "launches"),
               "mpo_linear_plain": (MK.mpo_linear_plain, "calls"),
               "mpo_linear_bwd_cores_plain": (MK.mpo_linear_bwd_cores_plain, "calls"),
               "flash_decode_attention_plain": (DA.flash_decode_attention_plain, "calls"),
               "ssd_scan_plain": (SSD.ssd_scan_plain, "calls")}
    plains = [k for k in watched if k.endswith("_plain")]

    def zero():
        for fn, attr in watched.values():
            setattr(fn, attr, 0)

    def counts():
        return {k: getattr(fn, attr) for k, (fn, attr) in watched.items()}

    by_path: dict = {}

    def fold(path, c):
        for k, n in c.items():
            if n and k not in plains:
                by_path.setdefault(k, {})[f"mesh {path}"] = n

    def no_plain(path, c):
        if any(c[k] for k in plains):
            fail(f"mesh {path}: a plain version ran on the card: {c}")

    def placed_as_rules(what, tree, axes, mesh, rules):
        """Every leaf a DTensor on ``mesh`` with the placements the rules give."""
        want = S.tree_shardings(axes, tree, mesh, rules)
        bad = []

        def visit(t, w, path):
            if isinstance(t, dict):
                for k in t:
                    visit(t[k], w[k], f"{path}/{k}")
            elif not (spmd.is_dtensor(t) and t.device_mesh is mesh
                      and tuple(t.placements) == tuple(w)):
                bad.append(path)
        visit(tree, want, "")
        if bad:
            fail(f"mesh {what}: leaves not placed by the rules: {bad[:8]}")

    own_world = LM.ensure_world("cuda")
    mesh = LM.make_host_mesh(model=1)
    rules = S.head_safe_rules(S.make_rules(mesh), configs.get_config("bert-base"), mesh)
    records = {}
    try:
        # (a) full-width bert-base, bf16, paged, cached and factorized
        sess = Session.init("bert-base", smoke=False, seed=SEED)
        prompts = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, sess.cfg.vocab_size, (BATCH, PROMPT)).astype(np.int64))
        serve_axes = sess.model.cache_weights(sess.params, axes=sess.axes)[1]
        for wc in (True, False):
            runs = {}
            for on_mesh in (False, True):
                kw = dict(paged=True, weight_cache=wc, mesh=mesh if on_mesh else None)
                h = sess.serve(BATCH, MAX_LEN, **kw)
                h.generate({"tokens": prompts}, 2)                      # warm-up
                h.reset()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero()
                t0 = time.perf_counter()
                logits = h.prefill({"tokens": prompts})
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                c_pre = counts()
                zero()
                tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
                out = [tok]
                for _ in range(NEW_TOKENS - 1):
                    tok, _ = h.decode(tok)
                    out.append(tok)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                c_dec = counts()
                runs[on_mesh] = dict(tokens=torch.cat(out, 1).cpu(), logits=logits.float(),
                                     pre=c_pre, dec=c_dec, prefill_ms=1e3 * (t1 - t0),
                                     decode_ms_per_step=1e3 * (t2 - t1) / (NEW_TOKENS - 1),
                                     peak_mem_bytes=torch.cuda.max_memory_allocated())
                sess._serve.clear()                 # each run's peak its own
                if on_mesh:
                    placed_as_rules(f"serve weight_cache={wc}", h.params,
                                    serve_axes if wc else sess.axes, mesh, rules)
                    want = S.cache_sharding(h.cache, mesh, rules)
                    if not all(spmd.is_dtensor(t) and tuple(t.placements) == tuple(want[k])
                               for k, t in h.cache.items()):
                        fail(f"mesh serve weight_cache={wc}: cache leaves not placed by "
                             "cache_sharding")
                del h
                torch.cuda.empty_cache()
            off, on = runs[False], runs[True]
            diff = (on["logits"] - off["logits"]).abs().max().item()
            scale = off["logits"].abs().max().item()
            path = f"bert-base serve weight_cache={wc}"
            rec = {k: {"off": off[k], "on": on[k]} for k in
                   ("prefill_ms", "decode_ms_per_step", "peak_mem_bytes")}
            emit(phase="mesh", step="serve", arch="bert-base", weight_cache=wc, paged=True,
                 batch=BATCH, prompt=PROMPT, max_len=MAX_LEN, new_tokens=NEW_TOKENS,
                 mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                 tokens_identical=bool(torch.equal(on["tokens"], off["tokens"])),
                 prefill_logits_max_abs_diff=diff, scale=scale, tol=PATH_TOL,
                 launches_per_prefill={"on": on["pre"], "off": off["pre"]},
                 launches_decode={"on": on["dec"], "off": off["dec"]}, **rec)
            records[path] = rec
            if not torch.equal(on["tokens"], off["tokens"]) or diff > PATH_TOL * scale:
                fail(f"mesh {path}: tokens or prefill logits differ from the same call off "
                     f"the mesh (logits by {diff} of {scale})")
            for c_on, c_off in ((on["pre"], off["pre"]), (on["dec"], off["dec"])):
                no_plain(path, c_on)
                if c_on != c_off:
                    fail(f"mesh {path}: launches {c_on} differ from the plan's {c_off}")
            if on["dec"]["flash_decode_attention"] == 0 or (
                    not wc and (on["pre"]["mpo_linear_fwd_mma"] == 0
                                or on["dec"]["mpo_linear_fwd_mma"] == 0)):
                fail(f"mesh {path}: flash decode or the MPO-linear forward never launched")
            fold(path, {k: on["pre"][k] + on["dec"][k] for k in watched})
        del sess
        torch.cuda.empty_cache()

        emit(phase="mesh", step="serve done", s=time.perf_counter() - t_phase)
        # (b) a float32 paged pool on the mesh against batch-1 serial generation
        fsess = Session.init("bert-base", smoke=False, seed=SEED, dtype="float32")
        trace = TRF.make_trace(POOL_REQUESTS, 8.0, seed=SEED, prompt_len=(16, 128),
                               max_new=(8, 32), vocab_size=30720)[:MESH_POOL_REQUESTS]
        h1 = fsess.serve(1, POOL_MAX_LEN, paged=True, page_size=POOL_PAGE)
        serial = []
        for r in trace:
            h1.reset()
            logits = h1.prefill({"tokens": r.prompt[None]})[:, -1]
            steps, tok = [logits], torch.argmax(logits, -1)[:, None].to(torch.int32)
            toks = [tok]
            for _ in range(r.max_new_tokens - 1):
                tok, lg = h1.decode(tok)
                toks.append(tok)
                steps.append(lg[:, -1])
            serial.append((torch.cat(toks, 1)[0].cpu().numpy(),
                           torch.cat(steps, 0).float().cpu()))
        del h1
        zero()
        clock = VirtualClock()
        pool = fsess.serve_pool(POOL_SLOTS, POOL_MAX_LEN, paged=True, page_size=POOL_PAGE,
                                mesh=mesh, clock=clock)
        report = TRF.replay(pool, trace, clock=clock)
        c = counts()
        no_plain("bert-base float32 pool", c)
        if c["flash_decode_attention"] == 0:
            fail("mesh bert-base float32 pool: flash decode never launched")
        ties, equal = [], 0
        for rid, (rec_, (ref, lg)) in enumerate(zip(report.records, serial)):
            toks = rec_["tokens"]
            if np.array_equal(toks, ref):
                equal += 1
                continue
            d = np.nonzero(toks[:min(len(toks), len(ref))] != ref[:min(len(toks), len(ref))])[0]
            if d.size == 0:
                fail(f"mesh pool: request {rid} has {len(toks)} tokens, serial {len(ref)}")
            top2 = lg[int(d[0])].topk(2).values
            margin, scale = (top2[0] - top2[1]).item(), lg[int(d[0])].abs().max().item()
            ties.append({"request": rid, "step": int(d[0]), "margin": margin})
            if not margin <= F32_TIE * scale:
                fail(f"mesh pool: request {rid} differs from serial generation at step "
                     f"{int(d[0])}, top-2 margin {margin} > {F32_TIE} x {scale}")
        st = pool.stats()
        emit(phase="mesh", step="pool", arch="bert-base", dtype="float32", slots=POOL_SLOTS,
             max_len=POOL_MAX_LEN, requests=len(trace), equal=equal, ties=ties,
             completed=report.summary["completed"], mesh_stats=st["mesh"],
             launches={k: v for k, v in c.items() if v})
        if report.summary["completed"] != len(trace) or st["mesh"] != {"data": 1, "model": 1}:
            fail(f"mesh pool: {report.summary}, mesh {st['mesh']}")
        fold("bert-base float32 pool", c)
        del pool, fsess
        torch.cuda.empty_cache()

        emit(phase="mesh", step="pool done", s=time.perf_counter() - t_phase)
        # (c) LFA steps on mesh-placed parameters, plain and int8-compressed
        cfg = configs.get_config("bert-base")
        bf = make_batch_fn(cfg, ShapeConfig("mesh", "train", TRAIN_SEQ, TRAIN_BATCH))
        batches = [{k: torch.as_tensor(v).cuda() for k, v in bf(i).items()}
                   for i in range(MESH_TRAIN_STEPS)]
        for compress in (None, "int8"):
            runs = {}
            for on_mesh in (False, True):
                model = build(cfg, seed=SEED)
                params = model.tree()
                if on_mesh:
                    params = S.place_tree(params, S.tree_shardings(model.axes, params, mesh,
                                                                   rules), mesh)
                    placed_as_rules("train params", params, model.axes, mesh, rules)
                mask = lightweight.trainable_mask(params, mode="lfa")
                opt = optimizers.adamw(2e-3, mask=mask)
                if compress:
                    opt = wrap_compression(opt, kind=compress, mask=mask)
                central0 = {k: spmd.local(v).clone() for k, v in
                            _central_leaves(params).items()}
                state = TrainState(params, opt.init(params))
                step = make_train_step(model, opt)
                losses, ms = [], []
                zero()
                for b in batches:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    state, met = step(state, b)
                    losses.append(float(met["loss"]))
                    ms.append(1e3 * (time.perf_counter() - t0))
                c = counts()
                moved = [k for k, v in _central_leaves(state.params).items()
                         if not torch.equal(spmd.local(v), central0[k])]
                runs[on_mesh] = dict(losses=losses, ms=ms, c=c, moved=moved)
                del model, params, state
            off, on = runs[False], runs[True]
            what = f"bert-base lfa {compress or 'plain'}"
            emit(phase="mesh", step="train", arch="bert-base", compress=compress,
                 batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses={"off": off["losses"],
                                                           "on": on["losses"]},
                 step_ms={"off": off["ms"], "on": on["ms"]}, tol=TRAIN_TOL,
                 launches={k: v for k, v in on["c"].items() if v})
            if not all(np.isfinite(on["losses"])) or not np.allclose(
                    on["losses"], off["losses"], rtol=TRAIN_TOL, atol=0):
                fail(f"mesh {what}: losses {on['losses']} vs off the mesh {off['losses']}")
            if on["moved"] or off["moved"]:
                fail(f"mesh {what}: central cores changed: {on['moved'][:4]}")
            no_plain(what, on["c"])
            if on["c"]["mpo_linear_bwd_cores"] == 0 or on["c"] != off["c"]:
                fail(f"mesh {what}: launches {on['c']} vs the plan's {off['c']}")
            fold(what, on["c"])
        torch.cuda.empty_cache()

        emit(phase="mesh", step="train done", s=time.perf_counter() - t_phase)
        # (d) mamba2-130m, full width, on the mesh
        msess = Session.init("mamba2-130m", smoke=False, seed=SEED)
        mprompts = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, msess.cfg.vocab_size, (MAMBA_BATCH, MAMBA_PROMPT)).astype(np.int64))
        runs = {}
        for on_mesh in (False, True):
            h = msess.serve(MAMBA_BATCH, MAMBA_MAX_LEN, mesh=mesh if on_mesh else None)
            h.generate({"tokens": mprompts}, 2)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
            t0 = time.perf_counter()
            out = h.generate({"tokens": mprompts}, NEW_TOKENS)
            torch.cuda.synchronize()
            runs[on_mesh] = dict(tokens=out.cpu(), c=counts(), s=time.perf_counter() - t0,
                                 peak=torch.cuda.max_memory_allocated())
            msess._serve.clear()
            if on_mesh and not (spmd.is_dtensor(h.cache)
                                and tuple(h.cache.placements) == tuple(
                                    S.cache_sharding(h.cache, mesh, rules))):
                fail("mesh mamba2-130m: the state is not placed by cache_sharding")
            del h
            torch.cuda.empty_cache()
        off, on = runs[False], runs[True]
        emit(phase="mesh", step="serve", arch="mamba2-130m", batch=MAMBA_BATCH,
             prompt=MAMBA_PROMPT, new_tokens=NEW_TOKENS,
             tokens_identical=bool(torch.equal(on["tokens"], off["tokens"])),
             generate_s={"off": off["s"], "on": on["s"]},
             peak_mem_bytes={"off": off["peak"], "on": on["peak"]},
             launches={k: v for k, v in on["c"].items() if v})
        no_plain("mamba2-130m serve", on["c"])
        if not torch.equal(on["tokens"], off["tokens"]) or on["c"]["ssd_scan"] == 0 \
                or on["c"] != off["c"]:
            fail(f"mesh mamba2-130m: tokens differ or launches {on['c']} vs {off['c']}")
        fold("mamba2-130m serve", on["c"])
        del msess
        torch.cuda.empty_cache()

        emit(phase="mesh", step="mamba done", s=time.perf_counter() - t_phase)
        # (e) every shard shape of (2, 4) and (4, 2) meshes, rank by rank
        shards = []
        flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
        for arch in MESH_ROWS:
            acfg = configs.get_config(arch)
            gen = torch.Generator().manual_seed(SEED)
            d, hd = acfg.d_model, acfg.num_heads * acfg.head_dim
            kvd = acfg.num_kv_heads * acfg.head_dim
            with L.annotating():
                mats = {"wq": L.init_linear(gen, d, hd, cfg=acfg.mpo, kind="attn",
                                            out_axis="qkv", sharded_out=True),
                        "wk": L.init_linear(gen, d, kvd, cfg=acfg.mpo, kind="attn",
                                            out_axis="kv_qkv", sharded_out=True),
                        "w_up": L.init_linear(gen, d, acfg.d_ff, cfg=acfg.mpo, kind="ffn",
                                              out_axis="ffn", sharded_out=True),
                        "w_down": L.init_linear(gen, acfg.d_ff, d, cfg=acfg.mpo, kind="ffn",
                                                in_axis="ffn", sharded_in=True)}
            for shape in MESH_EMULATED:
                standin = _MeshShape(shape)
                prules = S.head_safe_rules(S.make_rules(standin, fsdp=True), acfg, standin)
                for mname, lin in mats.items():
                    names = list(lin["cores"])
                    cores = [lin["cores"][n].value.cuda().to(torch.bfloat16)
                             for n in L.core_names(len(names))]
                    axes = [lin["cores"][n].axes for n in L.core_names(len(names))]
                    specs = [S.spec_for(a, tuple(c.shape), prules, standin)
                             for a, c in zip(axes, cores)]
                    i_dim = math.prod(c.shape[1] for c in cores)
                    for rows in MESH_ROWS[arch]:
                        x = torch.randn(rows, i_dim, generator=gen).cuda().to(torch.bfloat16)
                        if MK.forward_kernel(tuple(tuple(c.shape) for c in cores),
                                             "bfloat16") is None:
                            # no bf16 route for the whole matrix: the engine
                            # plans it factorized; its shards are recorded
                            shards.append({"arch": arch, "matrix": mname, "mesh": list(shape),
                                           "rows": rows, "route": None})
                            continue
                        whole = MK.mpo_linear(cores, x)
                        parts, roles = [], None
                        for r in range(shape[1]):
                            local, role = [], None
                            for k, (c, sp) in enumerate(zip(cores, specs)):
                                dim = next((j for j, e in enumerate(sp) if e == "model"
                                            or (isinstance(e, tuple) and "model" in e)), None)
                                if dim is None:          # FSDP shards are gathered at use
                                    local.append(c)
                                    continue
                                n = c.shape[dim] // shape[1]
                                local.append(c.narrow(dim, r * n, n).contiguous())
                                role = "col" if dim == 2 else "row"
                            xr = x
                            if role == "row":
                                n = i_dim // shape[1]
                                xr = x[:, r * n:(r + 1) * n].contiguous()
                            shapes = tuple(tuple(c.shape) for c in local)
                            route = MK.forward_kernel(shapes, "bfloat16")
                            if route is None:
                                fail(f"mesh shard {arch} {mname} {shape} rank {r}: the whole "
                                     f"matrix has a bf16 route, its shard {shapes} none")
                            y = MK.mpo_linear(local, xr)
                            ref = MK.mpo_linear_plain(local, xr)
                            err = (y.float() - ref.float()).abs().max().item()
                            scale = ref.float().abs().max().item()
                            ms = device_ms(lambda: MK.mpo_linear(local, xr), flush, 3)
                            if not (err <= TOL["bfloat16"] * scale and torch.isfinite(y).all()):
                                fail(f"mesh shard {arch} {mname} {shape} rank {r} rows {rows}: "
                                     f"err {err} > {TOL['bfloat16']} x {scale}")
                            parts.append(y)
                            roles = role
                            shards.append({"arch": arch, "matrix": mname, "mesh": list(shape),
                                           "model_rank": r, "rows": rows, "role": role,
                                           "core_shapes": [list(s) for s in shapes],
                                           "route": route, "ms": ms, "max_abs_err": err})
                        if roles == "col":          # the ranks' column blocks
                            y = torch.cat(parts, -1)
                        elif roles == "row":        # the ranks' partial sums
                            y = torch.stack([p.float() for p in parts]).sum(0)
                        else:                       # no model shard: each rank the whole
                            y = parts[0]
                        err = (y.float() - whole.float()).abs().max().item()
                        scale = whole.float().abs().max().item()
                        if not err <= 2 * TOL["bfloat16"] * scale:
                            fail(f"mesh assembled {arch} {mname} {shape} rows {rows}: err "
                                 f"{err} > {2 * TOL['bfloat16']} x {scale}")
                        shards[-1]["assembled_err"] = err
        emit(phase="mesh", step="shards", cases=len(shards), shards=shards,
             s=time.perf_counter() - t_phase)

        # (e) flash decode over a pool whose in-page positions are spread
        # over `model` (the rules' paged layout on (4, 2) and (2, 4)): each
        # model rank's block through the kernel with its softmax statistics,
        # against its plain version, and merged as spmd.combine_softmax
        # merges the ranks, against the unsplit kernel
        splits = []
        b, ps, mp = 8, 16, 16
        for arch in MESH_ROWS:
            acfg = configs.get_config(arch)
            kvh, dh = acfg.num_kv_heads, acfg.head_dim
            gen = torch.Generator().manual_seed(SEED)
            q = torch.randn(b, kvh, acfg.num_heads // kvh, dh, generator=gen)
            q = q.cuda().to(torch.bfloat16)
            kp, vp = (torch.randn(b * mp, ps, kvh, dh, generator=gen).cuda().to(torch.bfloat16)
                      for _ in range(2))
            table = torch.randperm(b * mp, generator=gen).reshape(b, mp).int().cuda()
            lengths = torch.randint(129, 161, (b,), generator=gen).int().cuda()
            bias = torch.where(torch.arange(mp * ps, device="cuda")[None] < lengths[:, None],
                               0.0, DA.MASK_VALUE).float().contiguous()
            whole = DA.flash_decode_attention(q, kp, vp, table, lengths, bias)
            scale = whole.float().abs().max().item()
            for m in sorted({shape[1] for shape in MESH_EMULATED}):
                lps = ps // m
                lens = (((lengths + ps - 1) // ps) * lps).int()
                parts, ranks = [], []
                for r in range(m):
                    blk = slice(r * lps, (r + 1) * lps)
                    args = (q, kp[:, blk].contiguous(), vp[:, blk].contiguous(), table, lens,
                            bias.unflatten(-1, (mp, ps))[..., blk].flatten(-2).contiguous())
                    o, mx, l = DA.flash_decode_attention(*args, stats=True)
                    ro, rmx, rl = DA.flash_decode_attention_plain(*args, stats=True)
                    errs = {"out": (o.float() - ro.float()).abs().max().item(),
                            "m": (mx - rmx).abs().max().item(),
                            "l": ((l - rl).abs() / rl.clamp(min=1.0)).max().item()}
                    if not (errs["out"] <= TOL["bfloat16"] * scale and errs["m"] <= 1e-3
                            * max(1.0, rmx.abs().max().item()) and errs["l"] <= 1e-3):
                        fail(f"mesh split decode {arch} model {m} rank {r}: {errs}")
                    ms = device_ms(lambda: DA.flash_decode_attention(*args, stats=True),
                                   flush, 3)
                    parts.append((o, mx, l))
                    ranks.append({"rank": r, "ms": ms, **errs})
                big = torch.stack([mx for _, mx, _ in parts]).amax(0)
                num = sum(o.float() * l * torch.exp(mx - big) for o, mx, l in parts)
                den = sum(l * torch.exp(mx - big) for _, mx, l in parts)
                err = ((num / den.clamp(min=1e-30)) - whole.float()).abs().max().item()
                if not err <= 2 * TOL["bfloat16"] * scale:
                    fail(f"mesh split decode {arch} model {m}: merged err {err} > "
                         f"{2 * TOL['bfloat16']} x {scale}")
                splits.append({"arch": arch, "model": m, "slots": b, "page_size": ps,
                               "local_page_size": lps, "kv": kvh, "merged_err": err,
                               "ranks": ranks})
        emit(phase="mesh", step="split decode", cases=splits, s=time.perf_counter() - t_phase)

        # (f) the training CLI in-process on the same world
        zero()
        _, hist = LT.main(["--arch", "bert-base", "--steps", "3", "--compress", "int8"])
        c = counts()
        loss = hist[-1]["loss"] if hist else float("nan")
        emit(phase="mesh", step="launch.train", final_loss=loss,
             launches={k: v for k, v in c.items() if v})
        if not np.isfinite(loss):
            fail(f"mesh launch.train: final loss {loss}")
        no_plain("launch.train", c)
        fold("launch.train bert-base int8", c)
        emit(phase="mesh", step="launch.train done", s=time.perf_counter() - t_phase)
        # (g) the moe, vlm, hybrid and encdec families on the (1, 1) mesh at
        # full width and cut depth, bf16: each call off and on the mesh in
        # turns, the same inputs
        def family_serve(what, sess, batch, rows, max_len, new, *, paged, wc, need):
            cfg = sess.cfg
            frules = S.head_safe_rules(S.make_rules(mesh), cfg, mesh)
            runs = {}
            for on_mesh in (False, True):
                h = sess.serve(rows, max_len, paged=paged, weight_cache=wc,
                               mesh=mesh if on_mesh else None)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                zero()
                t0 = time.perf_counter()
                logits = h.prefill(batch)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                c_pre = counts()
                zero()
                tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
                out = [tok]
                for _ in range(new - 1):
                    tok, _ = h.decode(tok)
                    out.append(tok)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                c_dec = counts()
                runs[on_mesh] = dict(tokens=torch.cat(out, 1).cpu(), logits=logits.float(),
                                     pre=c_pre, dec=c_dec, prefill_ms=1e3 * (t1 - t0),
                                     decode_ms_per_step=1e3 * (t2 - t1) / (new - 1),
                                     peak_gb=torch.cuda.max_memory_allocated() / 1e9)
                if on_mesh:
                    meta = lightweight.tree_map(lambda t: torch.empty_like(t, device="meta"),
                                                sess.params)
                    axes = sess.model.cache_weights(meta, axes=sess.axes)[1] if wc else sess.axes
                    placed_as_rules(what, h.params, axes, mesh, frules)
                    want, got = _flat(S.cache_sharding(h.cache, mesh, frules)), _flat(h.cache)
                    if not all(spmd.is_dtensor(t) and tuple(t.placements) == tuple(want[k])
                               for k, t in got.items()):
                        fail(f"mesh {what}: cache leaves not placed by cache_sharding")
                sess._serve.clear()
                del h, logits
                torch.cuda.empty_cache()
            off, on = runs[False], runs[True]
            diff = (on["logits"] - off["logits"]).abs().max().item()
            rec = {k: {"off": off[k], "on": on[k]} for k in
                   ("prefill_ms", "decode_ms_per_step", "peak_gb")}
            emit(phase="mesh", step="family serve", path=what, family=cfg.family,
                 layers=cfg.num_layers, rows=rows, max_len=max_len, new_tokens=new,
                 paged=paged, weight_cache=wc,
                 tokens_identical=bool(torch.equal(on["tokens"], off["tokens"])),
                 prefill_logits_bit_equal=bool(torch.equal(on["logits"], off["logits"])),
                 prefill_logits_max_abs_diff=diff,
                 launches_per_prefill={"on": on["pre"], "off": off["pre"]},
                 launches_decode={"on": on["dec"], "off": off["dec"]}, **rec)
            records[what] = rec
            if not torch.equal(on["tokens"], off["tokens"]) or not torch.equal(
                    on["logits"], off["logits"]):
                fail(f"mesh {what}: tokens or prefill logits differ from the same call off the "
                     f"mesh (logits by {diff})")
            for c_on, c_off in ((on["pre"], off["pre"]), (on["dec"], off["dec"])):
                no_plain(what, c_on)
                if c_on != c_off:
                    fail(f"mesh {what}: launches {c_on} differ from the plan's {c_off}")
            total = {k: on["pre"][k] + on["dec"][k] for k in watched}
            if any(total[k] == 0 for k in need):
                fail(f"mesh {what}: one of {need} never launched: {total}")
            fold(what, total)

        rng = np.random.default_rng(SEED + 17)
        # phi3.5-moe: paged, cached and factorized (the stacked forward over
        # the expert stack), then LFA steps on mesh-placed parameters
        pcfg = dataclasses.replace(configs.get_config(PHI35), num_layers=MESH_FAM_LAYERS[PHI35])
        psess = Session.init(pcfg, seed=SEED, init_device="cuda")
        pbatch = {"tokens": torch.from_numpy(rng.integers(
            0, pcfg.vocab_size, (MESH_FAM_BATCH, MESH_FAM_PROMPT)).astype(np.int64))}
        for wc in (True, False):
            family_serve(f"{PHI35} serve weight_cache={wc}", psess, pbatch, MESH_FAM_BATCH,
                         MESH_FAM_MAX_LEN, MESH_FAM_NEW, paged=True, wc=wc,
                         need=("flash_decode_attention",) if wc else
                         ("flash_decode_attention", "mpo_linear_fwd_mma_stacked"))
        del psess
        torch.cuda.empty_cache()
        bf = make_batch_fn(pcfg, ShapeConfig("mesh", "train", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH))
        pbatches = [{k: torch.as_tensor(v).cuda() for k, v in bf(i).items()}
                    for i in range(MESH_TRAIN_STEPS)]
        prules = S.head_safe_rules(S.make_rules(mesh), pcfg, mesh)
        runs = {}
        for on_mesh in (False, True):
            model = build(pcfg, seed=SEED, init_device="cuda")
            params = model.tree()
            if on_mesh:
                params = S.place_tree(params, S.tree_shardings(model.axes, params, mesh,
                                                               prules), mesh)
                placed_as_rules(f"{PHI35} train params", params, model.axes, mesh, prules)
            mask = lightweight.trainable_mask(params, mode="lfa")
            opt = optimizers.adamw(2e-3, mask=mask)
            central0 = {k: spmd.local(v).clone() for k, v in _central_leaves(params).items()}
            state = TrainState(params, opt.init(params))
            step = make_train_step(model, opt)
            losses, ms = [], []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero()
            for b in pbatches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, met = step(state, b)
                losses.append(float(met["loss"]))
                ms.append(1e3 * (time.perf_counter() - t0))
            c = counts()
            moved = [k for k, v in _central_leaves(state.params).items()
                     if not torch.equal(spmd.local(v), central0[k])]
            runs[on_mesh] = dict(losses=losses, ms=ms, c=c, moved=moved,
                                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            del model, params, state, central0
            torch.cuda.empty_cache()
        off, on = runs[False], runs[True]
        what = f"{PHI35} lfa"
        emit(phase="mesh", step="family train", path=what, layers=pcfg.num_layers,
             batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ,
             losses={"off": off["losses"], "on": on["losses"]},
             step_ms={"off": off["ms"], "on": on["ms"]},
             peak_gb={"off": off["peak_gb"], "on": on["peak_gb"]}, tol=TRAIN_TOL,
             launches={k: v for k, v in on["c"].items() if v})
        if not all(np.isfinite(on["losses"])) or not np.allclose(
                on["losses"], off["losses"], rtol=TRAIN_TOL, atol=0):
            fail(f"mesh {what}: losses {on['losses']} vs off the mesh {off['losses']}")
        if on["moved"] or off["moved"]:
            fail(f"mesh {what}: central cores changed: {on['moved'][:4]}")
        no_plain(what, on["c"])
        if on["c"]["mpo_linear_bwd_cores_stacked"] == 0 or on["c"] != off["c"]:
            fail(f"mesh {what}: launches {on['c']} vs the plan's {off['c']}")
        fold(what, on["c"])
        del pbatches

        # llava-next-34b: 1024 patches + 512 tokens, paged, both ways
        vcfg = dataclasses.replace(configs.get_config(LLAVA), num_layers=MESH_FAM_LAYERS[LLAVA])
        vsess = Session.init(vcfg, seed=SEED, init_device="cuda")
        vbatch = {"tokens": torch.from_numpy(rng.integers(
            0, vcfg.vocab_size, (MESH_FAM_BATCH, MESH_FAM_PROMPT)).astype(np.int64)),
            "patches": torch.from_numpy(rng.standard_normal(
                (MESH_FAM_BATCH, vcfg.frontend_len, vcfg.frontend_dim)).astype(np.float32))}
        for wc in (True, False):
            family_serve(f"{LLAVA} serve weight_cache={wc}", vsess, vbatch, MESH_FAM_BATCH,
                         LLAVA_MAX_LEN, MESH_FAM_NEW, paged=True, wc=wc,
                         need=("flash_decode_attention",) if wc else
                         ("flash_decode_attention", "mpo_linear_fwd_mma"))
        del vsess, vbatch
        torch.cuda.empty_cache()

        # zamba2-7b, one segment: the nested {"kv", "ssm"} cache, cached
        zcfg = dataclasses.replace(configs.get_config(HYBRID),
                                   num_layers=MESH_FAM_LAYERS[HYBRID])
        zsess = Session.init(zcfg, seed=SEED, init_device="cuda")
        zbatch = {"tokens": torch.from_numpy(rng.integers(
            0, zcfg.vocab_size, (MESH_FAM_BATCH, MESH_FAM_PROMPT)).astype(np.int64))}
        family_serve(f"{HYBRID} serve weight_cache=True", zsess, zbatch, MESH_FAM_BATCH,
                     MESH_FAM_MAX_LEN, MESH_FAM_NEW, paged=False, wc=True, need=("ssd_scan",))
        del zsess, zbatch
        torch.cuda.empty_cache()

        # whisper-tiny at full depth: the nested {"self", "enc_out"} cache
        wcfg = configs.get_config(ENCDEC)
        wsess = Session.init(wcfg, seed=SEED, init_device="cuda")
        wbatch = {"tokens": torch.from_numpy(rng.integers(
            0, wcfg.vocab_size, (ENC_BATCH, ENC_PROMPT)).astype(np.int64)),
            "frames": torch.from_numpy(rng.standard_normal(
                (ENC_BATCH, wcfg.frontend_len, wcfg.d_model)).astype(np.float32))}
        for wc in (True, False):
            family_serve(f"{ENCDEC} serve weight_cache={wc}", wsess, wbatch, ENC_BATCH,
                         ENC_MAX_LEN, MESH_FAM_NEW, paged=False, wc=wc,
                         need=() if wc else ("mpo_linear_fwd_mma",))
        del wsess, wbatch
        torch.cuda.empty_cache()
        emit(phase="mesh", step="families done", s=time.perf_counter() - t_phase)

        # (h) expert-parallel shard shapes, drawn alone: phi3.5-moe's and
        # llama4-maverick's w_up and w_down stacks cut by the production
        # rules' "expert": ("model",) at model = 4 and 2; each rank's local
        # stack through the stacked forward at a decode's and a prefill's
        # capacity rows against its plain version, the ranks' partial
        # combines summed against the unsharded kernel's; phi3.5's local
        # stack through the cores backward at a fine-tuning batch's rows
        ep = []
        for arch in (PHI35, LLAMA4):
            acfg = configs.get_config(arch)
            e = acfg.num_experts
            for name in ("w_up", "w_down"):
                stack = [c.to(torch.bfloat16) for c in expert_cores(acfg, name)]
                shapes = tuple(tuple(c.shape[1:]) for c in stack)
                i_dim = math.prod(s[1] for s in shapes)
                j_dim = math.prod(s[2] for s in shapes)
                gen = torch.Generator(device="cuda").manual_seed(SEED)
                for rows in (moe_capacity(acfg, 1), moe_capacity(acfg, MESH_FAM_PROMPT)):
                    x = torch.randn(e, rows, i_dim, generator=gen, device="cuda").to(
                        torch.bfloat16)
                    comb = torch.rand(e, rows, generator=gen, device="cuda")
                    whole = MK.mpo_linear(stack, x)
                    combined = torch.einsum("em,emj->mj", comb, whole.float())
                    scale = combined.abs().max().item()
                    for m in MESH_EP_MODEL:
                        n = e // m
                        spec = S.spec_for(("expert",) + (None,) * 4, (e,) + shapes[0],
                                          S.make_rules(_MeshShape((1, m))), _MeshShape((1, m)))
                        if spec[:1] != ("model",):
                            fail(f"mesh expert shards {arch} {name}: the rules put "
                                 f"{spec} on the expert dim at model={m}")
                        parts, outs = [], []
                        for r in range(m):
                            local = [c[r * n:(r + 1) * n].contiguous() for c in stack]
                            xr = x[r * n:(r + 1) * n].contiguous()
                            y = MK.mpo_linear(local, xr)
                            ref = MK.mpo_linear_plain(local, xr)
                            err = (y.float() - ref.float()).abs().max().item()
                            rscale = ref.float().abs().max().item()
                            if not (err <= TOL["bfloat16"] * rscale and torch.isfinite(y).all()):
                                fail(f"mesh expert shard {arch} {name} model={m} rank {r} "
                                     f"rows {rows}: err {err} > {TOL['bfloat16']} x {rscale}")
                            outs.append(y)
                            parts.append(torch.einsum("em,emj->mj", comb[r * n:(r + 1) * n],
                                                      y.float()))
                            if r:
                                continue                # every rank's shapes are rank 0's
                            w = mpo.reconstruct_stacked(local)
                            nbytes = 2 * (xr.numel() + sum(c.numel() for c in local)
                                          + n * rows * j_dim)
                            ops = 2 * n * rows * i_dim * j_dim
                            ep.append({
                                "kernel": "mpo_linear_fwd_mma", "arch": arch, "matrix": name,
                                "model": m, "experts_local": n, "rows": rows,
                                "core_shapes": [list(c.shape) for c in local],
                                "route": MK.forward_kernel(shapes, "bfloat16"),
                                "max_abs_err": err,
                                "ms": device_ms(lambda: MK.mpo_linear(local, xr), flush, 3),
                                "plain_ms": device_ms(lambda: MK.mpo_linear_plain(local, xr),
                                                      flush, 3),
                                "library_ms": device_ms(
                                    lambda: torch.matmul(xr, mpo.reconstruct_stacked(local)),
                                    flush, 3),
                                "dense_matmul_ms": device_ms(lambda: torch.matmul(xr, w),
                                                             flush, 3),
                                "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_S,
                                                      ops / PEAK_OPS_S["bfloat16"]),
                                "bound_by": "bytes" if nbytes / PEAK_BYTES_S
                                > ops / PEAK_OPS_S["bfloat16"] else "operations"})
                            del w
                        summed = torch.stack(parts).sum(0)
                        err = (summed - combined).abs().max().item()
                        if not err <= 2 * TOL["bfloat16"] * scale:
                            fail(f"mesh expert combine {arch} {name} model={m} rows {rows}: "
                                 f"err {err} > {2 * TOL['bfloat16']} x {scale}")
                        same = torch.equal(torch.cat(outs), whole)
                        ep.append({"combine": f"{arch} {name}", "model": m, "rows": rows,
                                   "summed_err": err, "scale": scale,
                                   "experts_bit_equal_to_unsharded": same})
                        del parts, outs
                    del x, whole
                if arch == PHI35:
                    m_train = moe_capacity(acfg, MOE_TRAIN_SEQ, MOE_TRAIN_BATCH)
                    for m in MESH_EP_MODEL:
                        n = e // m
                        local = [c[:n].contiguous() for c in stack]
                        xr = torch.randn(n, m_train, i_dim, generator=gen,
                                         device="cuda").to(torch.bfloat16)
                        dy = torch.randn(n, m_train, j_dim, generator=gen,
                                         device="cuda").to(torch.bfloat16)
                        got = MK.mpo_linear_bwd_cores(local, xr, dy)
                        ref = MK.mpo_linear_bwd_cores_plain(local, xr, dy)
                        err = 0.0
                        for k, (g, rf) in enumerate(zip(got, ref)):
                            ek = (g.float() - rf.float()).abs().max().item()
                            if not (ek <= TOL["bfloat16"] * rf.float().abs().max().item()
                                    and torch.isfinite(g).all()):
                                fail(f"mesh expert shard bwd {arch} {name} model={m} core {k}:"
                                     f" err {ek}")
                            err = max(err, ek)
                        del got, ref

                        def library():
                            cs = [c.detach().requires_grad_() for c in local]
                            w = mpo.reconstruct_stacked(cs)
                            return torch.autograd.grad(torch.bmm(xr, w), cs, dy)

                        plan = MK._bwd_plan(shapes, "bfloat16",
                                            torch.cuda.get_device_properties(0)
                                            .multi_processor_count)
                        ds = shapes[plan.split][0]
                        nbytes = 2 * (xr.numel() + dy.numel()
                                      + 2 * sum(c.numel() for c in local))
                        ops = n * (2 * m_train * i_dim * j_dim + 4 * ds * i_dim * j_dim)
                        ep.append({
                            "kernel": "mpo_linear_bwd_cores", "arch": arch, "matrix": name,
                            "model": m, "experts_local": n, "rows": m_train,
                            "core_shapes": [list(c.shape) for c in local], "route": "cuda",
                            "max_abs_err": err,
                            "ms": device_ms(lambda: MK.mpo_linear_bwd_cores(local, xr, dy),
                                            flush, 3),
                            "plain_ms": device_ms(
                                lambda: MK.mpo_linear_bwd_cores_plain(local, xr, dy), flush, 3),
                            "library_ms": device_ms(library, flush, 3),
                            "bound_ms": 1e3 * max(nbytes / PEAK_BYTES_S,
                                                  ops / PEAK_OPS_S["bfloat16"]),
                            "bound_by": "bytes" if nbytes / PEAK_BYTES_S
                            > ops / PEAK_OPS_S["bfloat16"] else "operations"})
                        del xr, dy, local
                del stack
                torch.cuda.empty_cache()
        emit(phase="mesh", step="expert shards", cases=ep, s=time.perf_counter() - t_phase)
    finally:
        if own_world:
            dist.destroy_process_group()
    emit(phase="mesh", s=time.perf_counter() - t_phase)
    return by_path


class _MeshShape:
    """A ("data", "model") mesh's shape without devices behind it — what
    the rule and spec functions read."""

    def __init__(self, shape):
        self.mesh_dim_names = ("data", "model")
        self.shape = tuple(shape)


# phase 18: the roofline's predicted step may pass the measured one by this
# factor (a floor above the measurement means the count is wrong), and the
# most the phase waits for its CPU half
ANALYSIS_SLACK, ANALYSIS_WAIT_S = 1.05, 900.0


def analysis_static(out: str) -> None:
    """18's CPU half, run in a process of its own with no card visible
    (``start_analysis_static``): the linter's sweep (every config at 1x1,
    1x4 and 2x4; sharding, kernel and trace; the compiler's register report
    of the libraries built), the fake-tensor host-transfer counts of
    bert-base's cached and factorized decode step at ``serve(BATCH,
    MAX_LEN, paged=True)`` after a ``PROMPT``-token prefill, and the dry run
    of bert-base's LFA step at phase 5's 16 x 128 on a (1, 1) fake world.
    Writes one JSON object to ``out``."""
    import torch
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.analysis import cli as LC
    from repro_torch.analysis import summarize
    from repro_torch.analysis import trace_lint as TLINT
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    res = {}
    t0 = time.perf_counter()
    found = LC.run_lint(sorted(configs.ARCHS), LC.parse_meshes("1x1,1x4,2x4"),
                        {"sharding", "kernel", "trace"}, ptxas=True)
    res["lint_s"] = time.perf_counter() - t0
    res["lint"] = summarize(found)
    res["lint_errors"] = [f.format() for f in found if f.severity == "error"]
    res["registers"] = [dataclasses.asdict(f) for f in found if f.check == "kernel/registers"]
    t0 = time.perf_counter()
    cfg = configs.get_config("bert-base")
    res["transfers"] = {str(wc): TLINT.decode_transfers(cfg, weight_cache=wc, paged=True,
                                                        batch=BATCH, prompt=PROMPT,
                                                        max_len=MAX_LEN)
                        for wc in (True, False)}
    res["transfers_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["dryrun"] = dryrun.run_cell("bert-base", ShapeConfig("lfa_16x128", "train", TRAIN_SEQ,
                                                             TRAIN_BATCH),
                                    mesh_shape=(1, 1), verbose=False)
    res["dryrun_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(res, f, default=str)


def start_analysis_static(tmp: Path):
    """Start ``analysis_static`` in a process of its own, at the lowest
    priority and with no card visible; returns ``(process, output path,
    log path)``.  The process is killed at exit if it still runs."""
    out, log = tmp / "analysis_static.json", tmp / "analysis_static.log"
    code = (f"import os, sys; os.nice(19); sys.path.insert(0, {str(ROOT)!r}); "
            f"import chip_smoke; chip_smoke.analysis_static({str(out)!r})")
    with open(log, "w") as fh:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), stdout=fh,
                                stderr=subprocess.STDOUT,
                                env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out, log


def analysis_phase(session_dir: str | None = None, train_ms: float | None = None,
                   static=None) -> None:
    """18. analysis — the static analysis and the dry run against the card
    (the module docstring's phase 18).  ``session_dir``: phase 5's saved
    session and ``train_ms`` its measured ms a step; ``static``: the
    running ``start_analysis_static`` job.  Alone (all None) it starts the
    job, builds the session and measures two LFA steps itself."""
    import warnings

    import numpy as np
    import torch

    from repro_torch import Session
    from repro_torch.analysis import trace_lint as TLINT

    t_phase = time.perf_counter()
    tmp = None
    try:
        if static is None:
            tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_analysis_"))
            static = start_analysis_static(tmp)
        if session_dir is None:
            sess = Session.init("bert-base", smoke=False, seed=SEED)
            ft = dict(mode="lfa", seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH)
            sess.finetune(steps=1, seed=SEED + 1, **ft)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.finetune(steps=2, seed=SEED, **ft)
            torch.cuda.synchronize()
            train_ms = 1e3 * (time.perf_counter() - t0) / 2
            restore_s = None
        else:
            t0 = time.perf_counter()
            sess = Session.restore(session_dir)
            restore_s = time.perf_counter() - t0

        # (b) the session's report
        t0 = time.perf_counter()
        ana = sess.report()["analysis"]
        report_s = time.perf_counter() - t0
        emit(phase="analysis", step="report", arch="bert-base", stage=sess.stage,
             restore_s=restore_s, report_s=report_s,
             **{k: ana.get(k) for k in ("errors", "warnings", "info", "by_check", "clean",
                                        "meshes", "error")})
        if "error" in ana or not ana.get("clean") or ana.get("errors"):
            fail(f"analysis: Session.report()['analysis'] of bert-base is not clean: {ana}")

        # (c) the decode step on the card, counted as the linter counts it
        rng = np.random.default_rng(SEED)
        prompts = torch.as_tensor(rng.integers(0, 1000, (BATCH, PROMPT)).astype(np.int32),
                                  device="cuda")
        card = {}
        for wc in (True, False):
            h = sess.serve(BATCH, MAX_LEN, paged=True, weight_cache=wc)
            h.reset()
            logits = h.prefill({"tokens": prompts})
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
            tok, _ = h.decode(tok)                 # plans memoized before the counted step
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    _, mode = TLINT.run_step(h.decode, tok)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            # (set_sync_debug_mode's own notice that it is a prototype is no sync)
            card[wc] = dict(mode.transfers(), sync_warnings=sum(
                "called a synchronizing" in str(w.message) for w in caught),
                which=dict(mode.syncs + mode.copies))
        del h, sess
        torch.cuda.empty_cache()

        # the CPU half
        proc, out, log = static
        try:
            proc.wait(timeout=max(1.0, ANALYSIS_WAIT_S - (time.perf_counter() - t_phase)))
        except subprocess.TimeoutExpired:
            proc.kill()
            fail(f"analysis: the static job did not finish within {ANALYSIS_WAIT_S} s")
        if proc.returncode != 0 or not out.exists():
            fail(f"analysis: the static job exited {proc.returncode}:\n"
                 f"{log.read_text()[-4000:]}")
        res = json.loads(out.read_text())
        waited_s = time.perf_counter() - t_phase

        # (a) the sweep
        emit(phase="analysis", step="lint", configs="all", meshes=["1x1", "1x4", "2x4"],
             families=["sharding", "kernel", "trace"], ptxas=True, s=res["lint_s"],
             **{k: res["lint"][k] for k in ("errors", "warnings", "info", "by_check")})
        for f in res["registers"]:
            emit(phase="analysis", step="registers", severity=f["severity"],
                 kernel=f["location"], message=f["message"])
        if res["lint"]["errors"] or res["lint_errors"]:
            fail(f"analysis: the linter reports errors: {res['lint_errors'][:10]}")
        if not any(f["severity"] == "info" for f in res["registers"]):
            fail("analysis: no register report was read from this run's builds")

        # (c) card against the fake-tensor trace
        for wc in (True, False):
            fake = res["transfers"][str(wc)]
            emit(phase="analysis", step="host transfers", arch="bert-base",
                 weight_cache=wc, card=card[wc], fake_cpu=fake, fake_s=res["transfers_s"])
            if (card[wc]["syncs"], card[wc]["copies"], card[wc]["sync_warnings"]) != \
                    (fake["syncs"], fake["copies"], fake["syncs"]):
                fail(f"analysis: bert-base decode (weight_cache={wc}) on the card counts "
                     f"{card[wc]}, the fake-tensor trace {fake}")

        # (d) the dry run's roofline beside phase 5's measured step
        dr = res["dryrun"]
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
        predicted_ms = 1e3 * dr["step_s"]
        emit(phase="analysis", step="dryrun", arch="bert-base", mesh=dr["mesh"],
             batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, s=res["dryrun_s"],
             flops_per_device=dr["flops_per_device"], bytes_per_device=dr["bytes_per_device"],
             bytes_written_per_device=dr["bytes_written_per_device"],
             collective_bytes=dr["collective_bytes"],
             peak_bytes_per_device=dr["peak_bytes_per_device"], model_flops=dr["model_flops"],
             compute_ms=1e3 * dr["compute_s"], memory_ms=1e3 * dr["memory_s"],
             collective_ms=1e3 * dr["collective_s"], dominant=dr["dominant"],
             predicted_ms=predicted_ms, measured_ms=train_ms,
             predicted_over_measured=predicted_ms / train_ms, nvidia_smi=smi)
        if not dr["flops_per_device"] > 0 or not predicted_ms <= ANALYSIS_SLACK * train_ms:
            fail(f"analysis: the dry run predicts {predicted_ms} ms a step, above "
                 f"{ANALYSIS_SLACK} x the measured {train_ms} ms (or counts no FLOPs)")
        if any(dr["collective_bytes"].values()):
            fail(f"analysis: collective bytes at (1, 1): {dr['collective_bytes']}")
        emit(phase="analysis", s=time.perf_counter() - t_phase, waited_s=waited_s,
             static_s=res["lint_s"] + res["transfers_s"] + res["dryrun_s"])
    finally:
        if static is not None and static[0].poll() is None:
            static[0].kill()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def moe_capacity(cfg, s: int, b: int = LLM_BATCH) -> int:
    """Rows an expert takes in a MoE layer of ``cfg`` from ``b`` sequences
    of ``s`` tokens (``models.moe``'s capacity, a sequence's times ``b``)."""
    return b * max(4, int(cfg.capacity_factor * s * cfg.top_k / cfg.num_experts))


def expert_cores(cfg, name: str) -> list:
    """One layer's expert matrix ``name`` of ``cfg``, stacked over the
    experts, drawn on the card from the seed with ``mpo.init_cores``'s
    scale (W of fan-in variance)."""
    import torch

    from repro_torch.core.layers import cores_to_list
    from repro_torch.models import transformer as TR
    with torch.device("meta"):
        layer = TR.init_layer(torch.Generator(), cfg)
    shapes = [tuple(c.shape) for c in cores_to_list(layer["moe"]["experts"][name]["cores"])]
    i_dim = math.prod(s[2] for s in shapes)
    sigma = (1.0 / i_dim / math.prod(s[4] for s in shapes[:-1])) ** (1 / (2 * len(shapes)))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    return [sigma * torch.randn(s, generator=g, device="cuda") for s in shapes]


def _flat(tree, prefix="") -> dict:
    """{path: leaf} of a nested dict (one tensor: {"": it})."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _central_leaves(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_central_leaves(v, f"{prefix}{k}/"))
        elif k == "central":
            out[prefix + k] = v
    return out


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError:
        fail("torch and numpy are needed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    try:
        from repro_torch import Session, configs
        from repro_torch.core import layers as L
        from repro_torch.core import lightweight, mpo
        from repro_torch.core.layers import cores_to_list
        from repro_torch.kernels import _build
        from repro_torch.kernels import decode_attention as DA
        from repro_torch.kernels import mpo_linear as MK
        from repro_torch.kernels import ssd_scan as SSD
        from repro_torch.models import mamba as MB
        from repro_torch.models import nn
        from repro_torch.timing import device_ms
    except ImportError as e:
        fail(f"the port is not importable next to this script ({e}); run it "
             "from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # phases 2-15 hold the analytic plans (their gates name them); phase 16
    # turns the autotuner's measuring back on
    from repro_torch.kernels import autotune
    os.environ[autotune.ENV_MEASURE] = "0"

    # ---- 1. device + build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         ptxas={n: [ln.strip() for ln in _build.build_log(n).splitlines()
                    if "registers" in ln or "spill" in ln]
                for n in _build.sources()})

    # phase 18's CPU half runs beside the card's phases from here on
    ana_tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_analysis_"))
    atexit.register(shutil.rmtree, ana_tmp, True)
    static_job = start_analysis_static(ana_tmp)

    gen = torch.Generator().manual_seed(SEED)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)

    def timed(fn, reps=10):
        """Mean device ms of ``fn`` over ``reps`` calls, L2 flushed before
        each (``repro_torch.timing.device_ms``)."""
        return device_ms(fn, flush_buf, reps)

    def check(name, out, ref, dtype, extra, tol=None):
        tol = TOL[dtype] if tol is None else tol
        err = (out.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not (err <= tol * scale and torch.isfinite(out).all()):
            fail(f"{name} {extra}: max abs err {err} > {tol} x {scale}")
        return err

    # ---- 2. kernels against their plain versions ----
    session = Session.init("bert-base", smoke=False, seed=SEED)
    layer0 = {k: {kk: v[0] for kk, v in lin["cores"].items()}
              for k, lin in session.params["layers"]["attn"].items()}
    layer0.update({k: {kk: v[0] for kk, v in lin["cores"].items()}
                   for k, lin in session.params["layers"]["mlp"].items()})
    mats = {"attn": cores_to_list(layer0["wq"]), "w_up": cores_to_list(layer0["w_up"]),
            "w_down": cores_to_list(layer0["w_down"])}
    results = {}

    mma_lib = MK._mma_lib()

    def fwd_case(mname, cores32, m, dtype, phase="kernels", reps=10, tol=None):
        """The MPO-linear forward through ``MK.mpo_linear`` against its plain
        version: the kernel ``MK.forward_kernel`` names for the shapes (the
        tensor-core kernel in both dtypes, ``csrc/mpo_linear.cu`` for narrow
        float32 shapes); two launches give the same bits; the plan's shared
        memory and workspace match the CUDA source's and the workspace stays
        under a quarter of a bf16 W's bytes.  5-D ``cores32`` are a stack of
        E matrices (a MoE layer's experts) with x (E, M, I): one launch a
        call, the stack's workspace E times a matrix's (the quarter-of-W
        gate per matrix), the library yardstick ``torch.matmul(x,
        reconstruct_stacked(cores))``.  ``tol`` replaces ``TOL`` where more
        terms are summed than it was set for; ``reps`` shortens the timing
        of a slow case."""
        tdt = getattr(torch, dtype)
        cores = [c.to(tdt).contiguous() for c in cores32]
        stack = cores[0].shape[:-4]                  # (E,) for an expert stack, else ()
        n = math.prod(stack)
        shapes = tuple(tuple(c.shape[-4:]) for c in cores)
        i_dim = math.prod(c[1] for c in shapes)
        j_dim = math.prod(c[2] for c in shapes)
        rebuild = mpo.reconstruct_stacked if stack else mpo.reconstruct
        x = torch.randn(*stack, m, i_dim, generator=gen).to(dev, tdt)
        route = MK.forward_kernel(shapes, dtype)
        counter = MK.mpo_linear_mma if route == "mma" else MK.mpo_linear_cuda_core
        before, sbefore = counter.launches, counter.stacked_launches
        y = MK.mpo_linear(cores, x)
        again = MK.mpo_linear(cores, x)
        torch.cuda.synchronize()
        if (counter.launches, counter.stacked_launches) != (before + 2, sbefore + 2 * (n > 1)):
            fail(f"{FWD_KERNEL[route]} {mname} M={m} {dtype}: not one launch of it a call, or "
                 "its stacked count wrong")
        if not torch.equal(y, again):
            fail(f"{FWD_KERNEL[route]} {mname} M={m} {dtype}: two launches differ")
        extra = {"experts": n} if stack else {}
        if route == "mma":
            plan = MK._mma_plan(shapes, m, dtype)
            dims = (ctypes.c_int * (4 * len(cores)))(*[d for sh in shapes for d in sh])
            code = MK.DTYPES[tdt]
            smem_c = mma_lib.mpo_linear_mma_smem(dims, len(cores), plan.split, plan.bm, code)
            ws_c = 4 * mma_lib.mpo_linear_mma_workspace(dims, len(cores), plan.split, m,
                                                        plan.splits, n, code)
            if (smem_c, ws_c) != (plan.smem, n * plan.workspace):
                fail(f"mpo_linear_fwd_mma {mname} {dtype}: the plan's shared memory / "
                     f"workspace {plan.smem} / {n * plan.workspace} differ from the CUDA "
                     f"source's {smem_c} / {ws_c}")
            if 4 * plan.workspace >= 2 * i_dim * j_dim:
                fail(f"mpo_linear_fwd_mma {mname} M={m}: workspace {plan.workspace} B a "
                     f"matrix is not below a quarter of its bf16 W's {2 * i_dim * j_dim} B")
            extra.update(split=plan.split, bm=plan.bm, tc=plan.tc, splits=plan.splits,
                         smem_bytes=plan.smem, workspace_bytes=n * plan.workspace,
                         w_bf16_bytes=2 * n * i_dim * j_dim)
        else:
            # csrc/mpo_linear.cu: its plan's shared memory and workspace (the
            # split partials) against the CUDA source's
            plan = MK._narrow_plan(shapes, m)
            lib = MK._lib()
            smem_c = lib.mpo_linear_fwd_smem(MK._dims(shapes), len(cores), plan.split, plan.bm,
                                             plan.ch, plan.lq)
            ws_c = lib.mpo_linear_fwd_workspace(MK._dims(shapes), len(cores), plan.split, m,
                                                plan.splits, n)
            if (smem_c, ws_c) != (plan.smem, n * plan.workspace):
                fail(f"mpo_linear_fwd {mname} M={m}: the plan's shared memory / workspace "
                     f"{plan.smem} / {n * plan.workspace} differ from the CUDA source's "
                     f"{smem_c} / {ws_c}")
            if 4 * plan.workspace >= 2 * i_dim * j_dim:
                fail(f"mpo_linear_fwd {mname} M={m}: workspace {plan.workspace} B a matrix is "
                     f"not below a quarter of its bf16 W's {2 * i_dim * j_dim} B")
            extra.update(split=plan.split, bm=plan.bm, rg=plan.rg, ch=plan.ch, lq=plan.lq,
                         splits=plan.splits, fast=plan.fast,
                         vec=plan.vec, smem_bytes=plan.smem, workspace_bytes=n * plan.workspace,
                         w_bf16_bytes=2 * n * i_dim * j_dim)
        ref = MK.mpo_linear_plain(cores, x)
        tol = TOL[dtype] if tol is None else tol
        err = check(FWD_KERNEL[route], y, ref, dtype, f"{mname} M={m} {dtype}", tol)
        del y, again, ref
        isz = x.element_size()
        nbytes = isz * (x.numel() + sum(c.numel() for c in cores) + n * m * j_dim)
        ops = 2 * n * m * i_dim * j_dim
        rec = dict(
            kernel=FWD_KERNEL[route], matrix=mname, shapes=[list(c.shape) for c in cores],
            M=m, dtype=dtype, max_abs_err=err, tol=tol, deterministic=True, **extra,
            kernel_ms=timed(lambda: MK.mpo_linear(cores, x), reps),
            plain_ms=timed(lambda: MK.mpo_linear_plain(cores, x), reps),
            library_ms=timed(lambda: torch.matmul(x, rebuild(cores)), reps),
            bound_ms=1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]),
            bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_OPS_S[dtype]
            else "operations")
        w = rebuild(cores)
        rec["dense_matmul_ms"] = timed(lambda: torch.matmul(x, w), reps)
        emit(phase=phase, **rec)
        del w
        torch.cuda.empty_cache()
        return rec

    for mname, cores32 in mats.items():
        for m in (8, BATCH * PROMPT):
            for dtype in ("bfloat16", "float32"):
                results[("mpo", mname, m, dtype)] = fwd_case(mname, cores32, m, dtype)
    for m in (1, 100):                       # one row, and a ragged M
        for dtype in ("bfloat16", "float32"):
            results[("mpo", "attn", m, dtype)] = fwd_case("attn", mats["attn"], m, dtype)
    # a narrow float32 matrix (smoke bert-base's wq at a smoke prefill's 4 x
    # 12 rows): the tensor-core plan refuses it, csrc/mpo_linear.cu runs
    smoke_wq = [c[0].to(dev) for c in cores_to_list(Session.init(
        configs.smoke_config("bert-base"), seed=SEED, device="cpu",
        dtype="float32").params["layers"]["attn"]["wq"]["cores"])]
    results[("mpo", "smoke wq", 48, "float32")] = fwd_case("smoke bert-base wq", smoke_wq, 48,
                                                          "float32")

    def flash_case(kv, g, dh, dtype, softcap, lens, window=None):
        """Flash decode against its plain version over ragged slots; with
        ``window``, each slot's bias masks the keys a local layer drops (the
        ones more than ``window`` behind its newest, as ``mask_local`` does)."""
        tdt = getattr(torch, dtype)
        ps, mp = 16, MAX_LEN // 16
        p = BATCH * mp
        q = torch.randn(BATCH, kv, g, dh, generator=gen).to(dev, tdt)
        kp = torch.randn(p, ps, kv, dh, generator=gen).to(dev, tdt)
        vp = torch.randn(p, ps, kv, dh, generator=gen).to(dev, tdt)
        lens_t = torch.tensor(lens, dtype=torch.int32)
        npg = (lens_t + ps - 1) // ps
        perm = torch.randperm(p, generator=gen).reshape(BATCH, mp).int()
        table = torch.where(torch.arange(mp)[None] < npg[:, None], perm, -1).int()
        kpos = torch.arange(mp * ps)[None]
        keep = kpos < lens_t[:, None]
        if window is not None:
            keep &= kpos >= lens_t[:, None] - window
        bias = torch.where(keep, 0.0, DA.MASK_VALUE).float()
        table, lens_d, bias = table.to(dev), lens_t.to(dev), bias.to(dev)
        args = (q, kp, vp, table, lens_d, bias)
        out = DA.flash_decode_attention(*args, softcap=softcap)
        again = DA.flash_decode_attention(*args, softcap=softcap)
        # the previous kernel (one block per slot and head, every page in
        # turn), reached by no path: the timed yardstick
        prev = torch.empty_like(q)
        stream = torch.cuda.current_stream().cuda_stream
        serial = lambda: DA._lib().flash_decode_attention_serial(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(), lens_d.data_ptr(),
            bias.data_ptr(), prev.data_ptr(), BATCH, kv, g, dh, p, ps, mp, 1.0 / math.sqrt(dh),
            float(softcap or 0.0), DA.DTYPES[tdt], stream)
        if serial() != 0:
            fail(f"the serial flash kernel did not launch at KV={kv} G={g} Dh={dh}")
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            fail(f"flash_decode_attention KV={kv} G={g} Dh={dh} lengths {lens}: two launches "
                 "differ")
        ref = DA.flash_decode_attention_plain(*args, softcap=softcap)
        err = check("flash_decode_attention", out, ref, dtype,
                    f"KV={kv} G={g} Dh={dh} softcap={softcap} lengths {lens}")
        check("flash_decode_attention_serial", prev, ref, dtype, f"KV={kv} G={g} Dh={dh}")
        plan = DA._flash_plan(BATCH, kv, g, dh, ps, mp)
        isz = q.element_size()
        keys = int((npg * ps).sum())
        nbytes = (isz * (2 * q.numel() + 2 * keys * kv * dh) + 4 * int(npg.sum())
                  + 4 * BATCH + 4 * keys)
        ops = 4 * kv * g * dh * keys                  # q.k and w.v per key and query head
        library_ms = None
        if not softcap:
            kg = DA.gather_pages(kp, table).transpose(1, 2).contiguous()   # (B, KV, S, Dh)
            vg = DA.gather_pages(vp, table).transpose(1, 2).contiguous()
            valid = torch.arange(mp * ps, device=dev)[None] < (npg.to(dev) * ps)[:, None]
            amask = bias.masked_fill(~valid, float("-inf"))[:, None, None, :].to(tdt)
            library_ms = timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kg, vg, attn_mask=amask))
        rec = dict(kernel="flash_decode_attention", KV=kv, G=g, Dh=dh, page_size=ps,
                   lengths=lens, softcap=softcap, window=window, dtype=dtype, max_abs_err=err,
                   tol=TOL[dtype], splits=plan.splits, kt=plan.kt, deterministic=True,
                   kernel_ms=timed(lambda: DA.flash_decode_attention(*args, softcap=softcap)),
                   prev_ms=timed(serial),
                   plain_ms=timed(lambda: DA.flash_decode_attention_plain(*args,
                                                                          softcap=softcap)),
                   library_ms=library_ms,
                   bound_ms=1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]),
                   bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_OPS_S[dtype]
                   else "operations")
        emit(phase="kernels", **rec)
        return rec

    ragged = [0, 1, 17, 128, 129, 200, 255, 256]
    for dtype in ("bfloat16", "float32"):
        flash_case(12, 1, 64, dtype, None, ragged)                 # bert-base geometry
        flash_case(8, 5, 128, dtype, None, ragged)                 # qwen3-14b geometry
        flash_case(8, 5, 128, dtype, 50.0, [5, 1, 0, 33, 129, 64, 250, 16])
        # page and split boundaries: both plans give a full slot's 16 pages
        # a split each (S = 16), so shorter slots leave splits empty
        flash_case(12, 1, 64, dtype, None, [15, 16, 31, 32, 33, 64, 65, 240])
        flash_case(8, 5, 128, dtype, None, [48, 63, 64, 65, 96, 127, 192, 256])
        # the serving path's own geometry: every slot at the same length
        results[("flash", "path", dtype)] = flash_case(12, 1, 64, dtype, None,
                                                       [PROMPT + 16] * BATCH)
        # the dense LLM configurations' geometries, ragged: gemma2-27b's (KV =
        # 16, G = 2) with its softcap 50 and a local layer's window bias (64
        # keys, so that it binds within a slot's 256 here; its own 4096 binds
        # in phase 10's 4352-token prompt), mistral-nemo-12b's (G = 4) and
        # nemotron-4-15b's (G = 6)
        results[("flash", "gemma2-27b", dtype)] = flash_case(16, 2, 128, dtype, 50.0, ragged,
                                                             window=64)
        results[("flash", "mistral-nemo-12b", dtype)] = flash_case(8, 4, 128, dtype, None,
                                                                   ragged)
        results[("flash", "nemotron-4-15b", dtype)] = flash_case(8, 6, 128, dtype, None, ragged)

    # the SSD scan at mamba2-130m's head geometry, and the MPO-linear forward
    # at its projections
    msess = Session.init("mamba2-130m", smoke=False, seed=SEED)
    mcfg = msess.cfg

    def ssd_case(bs, s, dtype, geom=None, phase="kernels"):
        """The SSD scan against its plain version at ``geom``'s heads, head
        width, state and chunk (mamba2-130m's when None)."""
        geom = geom or mcfg
        tdt = getattr(torch, dtype)
        h, p, n = geom.ssm_heads, geom.ssm_head_dim, geom.ssm_state
        x = torch.randn(bs, s, h, p, generator=gen).to(dev, tdt)
        # steps of ~0.02 (softplus(z - 4)): the state decays by ~e^-2.5 over
        # a chunk of 128, so the carry across chunks weighs in y
        dt = torch.nn.functional.softplus(torch.randn(bs, s, h, generator=gen) - 4).to(dev)
        a_log = (0.5 * torch.randn(h, generator=gen)).to(dev)
        b = (0.3 * torch.randn(bs, s, n, generator=gen)).to(dev, tdt)
        c = (0.3 * torch.randn(bs, s, n, generator=gen)).to(dev, tdt)
        d_skip = (1 + 0.1 * torch.randn(h, generator=gen)).to(dev)
        args, chunk = (x, dt, a_log, b, c, d_skip), geom.ssm_chunk
        y, state = SSD.ssd_scan(*args, chunk)
        again, state_again = SSD.ssd_scan(*args, chunk)
        torch.cuda.synchronize()
        if not (torch.equal(y, again) and torch.equal(state, state_again)):
            fail(f"ssd_scan B={bs} S={s} {dtype}: two launches differ")
        ry, rstate = SSD.ssd_scan_plain(*args, chunk)
        q = min(chunk, s)
        # the plan against the CUDA source (shared memory, scratch, and launch
        # 3's blocks an SM at every head group the plan weighs), then each of
        # the three launches alone on the card (the scratch filled by a whole
        # call first)
        plan = SSD._ssd_plan(bs, s, h, p, n, q, dtype, MK._sm_count(0))
        code = SSD.DTYPES[tdt]
        smem_c = tuple(ssd_lib.ssd_scan_smem(k, q, n, p, plan.group, code) for k in (1, 2, 3))
        ws_c = ssd_lib.ssd_scan_workspace(bs, s, h, p, n, q)
        if (smem_c, ws_c) != (plan.smem, plan.workspace):
            fail(f"ssd_scan B={bs} S={s} {dtype}: the plan's shared memory / scratch "
                 f"{plan.smem} / {plan.workspace} differ from the CUDA source's {smem_c} / {ws_c}")
        groups = [g for g in range(1, min(h, SSD.SSD_GMAX) + 1) if h % g == 0]
        res_py = [SSD._ssd_resident(q, n, p, g, dtype) for g in groups]
        res_c = [ssd_lib.ssd_scan_resident(q, n, p, g, code) for g in groups]
        if res_py != res_c:
            fail(f"ssd_scan B={bs} S={s} {dtype}: the plan's launch-3 blocks an SM {res_py} "
                 f"at head groups {groups} differ from the card's {res_c}")
        ws = torch.empty(plan.workspace // 4, dtype=torch.float32, device=dev)
        y1, state1 = torch.empty_like(y), torch.empty_like(state)
        stream = torch.cuda.current_stream().cuda_stream

        def run(launch):
            return lambda: SSD._run(x, dt, a_log, b, c, d_skip, y1, state1, ws, q, plan.group,
                                    stream, launch)

        if run(0)() != 0:
            fail(f"ssd_scan B={bs} S={s} {dtype}: the launches were refused")
        launch_ms = [timed(run(k)) for k in range(1, SSD.SSD_KERNELS + 1)]
        err = check("ssd_scan", y, ry, dtype, f"B={bs} S={s} q={q} {dtype}")
        serr = (state - rstate).abs().max().item()
        sscale = rstate.abs().max().item()
        if not (serr <= STATE_TOL * sscale and torch.isfinite(state).all()):
            fail(f"ssd_scan final state B={bs} S={s} {dtype}: max abs err {serr} > "
                 f"{STATE_TOL} x {sscale}")
        isz = x.element_size()
        nbytes = isz * (2 * x.numel() + b.numel() + c.numel()) + 4 * (
            dt.numel() + 2 * h + state.numel())
        # the causal half of each chunk's C.B^T, which every head shares, then
        # per head its decayed product with x, the chunk state B^T (x o s), and
        # C.prev for every chunk but the first, which carries no state
        tri, nc = q * (q + 1) // 2, s // q
        ops = 2 * bs * nc * tri * n + 2 * bs * h * (nc * (tri * p + q * n * p)
                                                     + (nc - 1) * q * n * p)
        # float32's bound above takes the CUDA cores' f32 rate; the kernel
        # reaches float32 with six bf16 products on the tensor cores, whose
        # rate (989 / 6 TFLOP/s) gives the bound for that route
        tc_bound = (1e3 * max(nbytes / PEAK_BYTES_S, 6 * ops / PEAK_OPS_S["bfloat16"])
                    if dtype == "float32" else None)
        rec = dict(kernel="ssd_scan", B=bs, S=s, H=h, P=p, N=n, chunk=q, dtype=dtype,
                   max_abs_err=err, state_max_abs_err=serr, tol=TOL[dtype],
                   state_tol=STATE_TOL, deterministic=True, group=plan.group,
                   grids=list(plan.grids), smem_bytes=list(plan.smem),
                   workspace_bytes=plan.workspace, launches_per_call=SSD.SSD_KERNELS,
                   launch_ms=launch_ms, tc_bound_ms=tc_bound,
                   kernel_ms=timed(lambda: SSD.ssd_scan(*args, chunk)),
                   plain_ms=timed(lambda: SSD.ssd_scan_plain(*args, chunk)),
                   library_ms=None,
                   bound_ms=1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]),
                   bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_OPS_S[dtype]
                   else "operations")
        emit(phase=phase, **rec)
        return rec

    ssd_lib = SSD._lib()
    for dtype in ("bfloat16", "float32"):
        results[("ssd", "path", dtype)] = ssd_case(MAMBA_BATCH, MAMBA_PROMPT, dtype)
        results[("ssd", "short", dtype)] = ssd_case(MAMBA_BATCH, 100, dtype)
        results[("ssd", "long", dtype)] = ssd_case(1, 4096, dtype)
    for mname in ("in_proj", "out_proj"):
        cores32 = [c[0] for c in cores_to_list(msess.params["layers"][mname]["cores"])]
        for m in (8, MAMBA_BATCH * MAMBA_PROMPT):
            for dtype in ("bfloat16", "float32"):
                results[("mpo", mname, m, dtype)] = fwd_case(f"mamba2-130m {mname}", cores32,
                                                             m, dtype)
        if mname == "in_proj":
            for m in (1, 100):
                for dtype in ("bfloat16", "float32"):
                    results[("mpo", mname, m, dtype)] = fwd_case(
                        f"mamba2-130m {mname}", cores32, m, dtype)
    # the tied head, E^T (768 -> 50432), at a decode step's M = 8
    head = mpo.transpose_cores(cores_to_list(msess.params["embed"]["cores"]))
    for dtype in ("bfloat16", "float32"):
        results[("mpo", "head", MAMBA_BATCH, dtype)] = fwd_case(
            "mamba2-130m head", head, MAMBA_BATCH, dtype)

    # the bf16 forward at the dense LLM configurations' matrices (one layer
    # and the embedding drawn for each): a decode step's M = 8 and a
    # prefill's 8 x 512
    from repro_torch.models import transformer as TR

    def llm_matrix(arch, name):
        cfg = configs.get_config(arch)
        lg = torch.Generator().manual_seed(SEED)
        if name == "head":
            emb = L.init_embedding(lg, cfg.vocab_size, cfg.d_model, cfg=cfg.mpo)
            return [c.to(dev) for c in mpo.transpose_cores(cores_to_list(emb["cores"]))]
        layer = TR.init_layer(lg, cfg)
        return [c.to(dev) for c in
                cores_to_list(layer["attn" if name in layer["attn"] else "mlp"][name]["cores"])]

    llm_m = LLM_BATCH * LLM_PROMPT
    for arch, name, ms in (("gemma2-27b", "wq", (8, llm_m)), ("gemma2-27b", "head", (8,)),
                           ("mistral-nemo-12b", "w_up", (llm_m,)),
                           ("nemotron-4-15b", "wq", (8, llm_m))):
        cores32 = llm_matrix(arch, name)
        for m in ms:
            results[("mpo", arch, name, m, "bfloat16")] = fwd_case(f"{arch} {name}", cores32, m,
                                                                   "bfloat16")
        del cores32

    # ---- 3. the serving paths at full width ----
    def kernel_mode(cfg):
        """``cfg`` with every factorized matmul in the kernel mode."""
        return dataclasses.replace(cfg, mpo=dataclasses.replace(cfg.mpo, mode="kernel"))

    counters = ((MK.mpo_linear_cuda_core, "launches"), (MK.mpo_linear_mma, "launches"),
                (MK.mpo_linear_cuda_core, "stacked_launches"),
                (MK.mpo_linear_mma, "stacked_launches"), (DA.flash_decode_attention, "launches"),
                (SSD.ssd_scan, "launches"), (MK.mpo_linear_plain, "calls"),
                (DA.flash_decode_attention_plain, "calls"), (SSD.ssd_scan_plain, "calls"))
    plains = ("mpo_linear_plain", "flash_decode_attention_plain", "ssd_scan_plain")

    def zero_counts():
        for fn, attr in counters:
            setattr(fn, attr, 0)

    def read_counts():
        return {"mpo_linear_fwd": MK.mpo_linear_cuda_core.launches,
                "mpo_linear_fwd_mma": MK.mpo_linear_mma.launches,
                "mpo_linear_fwd_stacked": MK.mpo_linear_cuda_core.stacked_launches,
                "mpo_linear_fwd_mma_stacked": MK.mpo_linear_mma.stacked_launches,
                "flash_decode_attention": DA.flash_decode_attention.launches,
                "ssd_scan": SSD.ssd_scan.launches,
                "mpo_linear_plain": MK.mpo_linear_plain.calls,
                "flash_decode_attention_plain": DA.flash_decode_attention_plain.calls,
                "ssd_scan_plain": SSD.ssd_scan_plain.calls}

    def serve_run(sess, arch, prompts, max_len, kernels, new_tokens=NEW_TOKENS, extra=None,
                  **serve_kw):
        """Warm up, then one timed prefill and ``new_tokens`` - 1 decode steps,
        the launch counts zeroed just before each and read just after; emits
        the run's record and fails on non-finite output, a factorized run
        that never launched the MPO-linear kernel, or any plain-version call.
        ``extra`` joins the prompt batch (a VLM's ``patches``).  Returns
        (handle, launches a prefill, launches in decode, logits)."""
        batch = len(prompts)
        inputs = dict(extra or {}, tokens=prompts)
        handle = sess.serve(batch, max_len, **serve_kw)
        handle.generate(inputs, 2)                      # warm-up, not timed
        handle.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
        zero_counts()
        t0 = time.perf_counter()
        logits = handle.prefill(inputs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        per_prefill = read_counts()
        zero_counts()
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        out, steps = [tok], []
        for _ in range(new_tokens - 1):
            tok, step_logits = handle.decode(tok)
            out.append(tok)
            steps.append(step_logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        per_decode = read_counts()
        n_dec = new_tokens - 1
        decode_step_ms[(arch, serve_kw.get("weight_cache", True))] = 1e3 * (t2 - t1) / n_dec
        cache = list(lightweight.leaves(handle.cache))     # a dict (nested: hybrid), a tensor
        finite = (bool(torch.isfinite(logits).all())
                  and all(bool(torch.isfinite(s).all()) for s in steps)
                  and all(bool(torch.isfinite(t).all()) for t in cache if t.is_floating_point()))
        tokens = torch.cat(out, 1)
        wc = serve_kw.get("weight_cache", True)
        emit(phase="path", arch=arch, dtype=sess.cfg.dtype, **serve_kw, batch=batch,
             prompt=prompts.shape[1], max_len=max_len, new_tokens=new_tokens,
             prefill_ms=1e3 * (t1 - t0), decode_ms_per_step=1e3 * (t2 - t1) / n_dec,
             tokens_per_s=batch * new_tokens / (t2 - t0),
             peak_mem_bytes=torch.cuda.max_memory_allocated(), mem_before_bytes=mem_before,
             cache_bytes=sum(t.numel() * t.element_size() for t in cache),
             launches_per_prefill={k: per_prefill[k] for k in kernels},
             launches_per_decode_step={k: per_decode[k] / n_dec for k in kernels},
             plain_calls=sum(per_prefill[k] + per_decode[k] for k in plains),
             logits_finite=finite, tokens_shape=list(tokens.shape),
             compression_ratio=sess.report()["compression_ratio"])
        if not finite or tokens.shape != (batch, new_tokens):
            fail(f"{arch} weight_cache={wc}: non-finite logits or cache, or tokens of "
                 f"shape {tuple(tokens.shape)}")
        # the full-width matrices run the tensor-core kernel, never
        # csrc/mpo_linear.cu; a factorized run launches it in prefill and decode
        fwd, other = "mpo_linear_fwd_mma", "mpo_linear_fwd"
        if not wc and (per_prefill[fwd] == 0 or per_decode[fwd] == 0):
            fail(f"{arch} weight_cache=False: prefill or decode never launched {fwd}")
        if per_prefill[other] or per_decode[other]:
            fail(f"{arch} weight_cache={wc}: {other} ran on a {sess.cfg.dtype} path")
        if any(per_prefill[k] or per_decode[k] for k in plains):
            fail(f"{arch} weight_cache={wc}: a plain version ran on the card's path")
        for k in kernels:
            path_launches[k] = path_launches.get(k, 0) + per_prefill[k] + per_decode[k]
            by_path.setdefault(k, {})[f"{arch} serve weight_cache={wc}"] = (
                per_prefill[k] + per_decode[k])
        return handle, per_prefill, per_decode, logits.float()

    prompts = np.random.default_rng(SEED).integers(
        0, session.cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    path_launches = {}
    by_path = {}             # kernel -> {path: launches}
    decode_step_ms = {}      # (arch, weight_cache) -> phase 3's decode ms a step
    prefill_logits = {}
    for wc in (True, False):
        handle, _, per_decode, prefill_logits[wc] = serve_run(
            session, "bert-base", prompts, MAX_LEN,
            ("mpo_linear_fwd_mma", "flash_decode_attention"), paged=True, weight_cache=wc)
        if per_decode["flash_decode_attention"] == 0:
            fail(f"weight_cache={wc}: decode never launched the flash kernel")
    diff = (prefill_logits[True] - prefill_logits[False]).abs().max().item()
    scale = prefill_logits[True].abs().max().item()
    emit(phase="path", prefill_logits_max_abs_diff=diff, scale=scale, tol=PATH_TOL)
    if diff > PATH_TOL * scale:
        fail(f"prefill logits of the two runs differ by {diff} > {PATH_TOL} x {scale}")
    del session, handle      # mamba2-130m's peak memory below is its own

    def layer_check(handle, wc, per_prefill):
        """The bf16 prefill layer by layer: each block on the card (the
        kernels) and on the CPU (the plain versions), both given the block
        input the card's run produced, then the final norm and head.  The
        model is too chaotic at 24 layers for an end-to-end comparison
        (``tests/test_torch_mamba.py::test_bf16_drift_over_depth_is_the_references``),
        so each step is held on its own.  The card's replay must launch the
        kernels as the timed prefill did; the CPU side runs every factorized
        matrix in the kernel mode, whose CPU path is the kernel's plain
        version (the CPU's own plan would rebuild W rounded to bf16: another
        function)."""
        params = handle.params
        cpu_params = lightweight.tree_map(lambda t: t.cpu(), params)
        ccfg = kernel_mode(mcfg)
        t0 = time.perf_counter()
        worst = {"delta": 0.0, "state": 0.0}
        zero_counts()
        with torch.no_grad():
            x = MB._embed(params, torch.as_tensor(mprompts, device=dev), mcfg, "prefill")
            for i in range(mcfg.num_layers):
                y, st = MB.apply_mamba_block(nn.index_layer(params["layers"], i), x, mcfg,
                                             phase="prefill")
                xc = x.cpu()
                yc, stc = MB.apply_mamba_block(nn.index_layer(cpu_params["layers"], i), xc,
                                               ccfg, phase="prefill")
                errs = {"delta": ((y.cpu().float() - yc.float()).norm()
                                  / (yc.float() - xc.float()).norm()).item(),
                        "state": ((st.cpu() - stc).norm() / stc.norm()).item()}
                for k, v in errs.items():
                    if not v <= LAYER_TOL:
                        fail(f"mamba2-130m bf16 weight_cache={wc} layer {i}: the card's "
                             f"block differs from the CPU's: {k} {v} > {LAYER_TOL}")
                    worst[k] = max(worst[k], v)
                x = y
            hidden = nn.apply_rmsnorm(params["final_norm"], x)[:, -1:]
            head = L.apply_logits(params["embed"], hidden, cfg=mcfg.mpo, phase="prefill")
            replay = read_counts()
            hc = L.apply_logits(cpu_params["embed"], hidden.cpu(), cfg=ccfg.mpo,
                                phase="prefill")
            herr = ((head.cpu().float() - hc.float()).norm() / hc.float().norm()).item()
        if any(replay[k] != per_prefill[k] for k in ("mpo_linear_fwd_mma", "ssd_scan")):
            fail(f"mamba2-130m bf16 weight_cache={wc}: the card's replay launched {replay}, "
                 f"the timed prefill {per_prefill}")
        emit(phase="path", arch="mamba2-130m", weight_cache=wc, layer_check="card_vs_cpu",
             layers=mcfg.num_layers, max_delta_rel_err=worst["delta"],
             max_state_rel_err=worst["state"], head_rel_err=herr, tol=LAYER_TOL,
             cpu_and_card_s=time.perf_counter() - t0)
        if not herr <= LAYER_TOL:
            fail(f"mamba2-130m bf16 weight_cache={wc}: the head's logits on the card differ "
                 f"from the CPU's: {herr} > {LAYER_TOL}")

    # full-width mamba2-130m, bf16: every layer's prefill through the SSD scan
    mprompts = np.random.default_rng(SEED + 1).integers(
        0, mcfg.vocab_size, (MAMBA_BATCH, MAMBA_PROMPT)).astype(np.int32)
    mamba_logits = {}
    for wc in (True, False):
        handle, per_prefill, per_decode, mamba_logits[wc] = serve_run(
            msess, "mamba2-130m", mprompts, MAMBA_MAX_LEN, ("mpo_linear_fwd_mma", "ssd_scan"),
            weight_cache=wc)
        # both ways the tied head runs the bf16 kernel, in prefill and decode
        if per_prefill["mpo_linear_fwd_mma"] == 0 or per_decode["mpo_linear_fwd_mma"] == 0:
            fail(f"mamba2-130m weight_cache={wc}: the head never launched mpo_linear_fwd_mma")
        if per_prefill["ssd_scan"] != mcfg.num_layers or per_decode["ssd_scan"]:
            fail(f"mamba2-130m weight_cache={wc}: {per_prefill['ssd_scan']} SSD-scan "
                 f"launches a prefill (expected {mcfg.num_layers}), "
                 f"{per_decode['ssd_scan']} in decode (expected 0)")
        layer_check(handle, wc, per_prefill)
    # reported, not gated: the two runs round W differently, and 24 layers of
    # the randomly drawn model amplify any rounding difference until the
    # logits disagree; the reference's bf16 drifts from its f32 as far
    # (tests/test_torch_mamba.py).  layer_check holds the bf16 path step by
    # step; phase 4 holds the float32 logits and tokens of the two runs
    emit(phase="path", arch="mamba2-130m",
         prefill_logits_max_abs_diff=(mamba_logits[True] - mamba_logits[False]).abs().max().item(),
         scale=mamba_logits[True].abs().max().item())
    del msess, handle

    # ---- 4. float32 token parity, then the smoke model card vs CPU ----
    def greedy_runs(what, sess, prompts, max_len, new_tokens, extra=None):
        """Greedy generation three ways, each handle dropped after its run:
        paged + factorized, paged + weight cache, the unpaged (dense) cache
        + weight cache (``extra`` joins the prompt batch).  Fails unless the
        tokens are identical.  Returns ``({run: (tokens, each step's logits)}
        on the CPU, min top-2 margin, {run: wall s})``."""
        runs, wall = {}, {}
        for name, kw in (("paged_factorized", dict(paged=True, weight_cache=False)),
                         ("paged_cached", dict(paged=True, weight_cache=True)),
                         ("dense_cached", dict(paged=False, weight_cache=True))):
            t0 = time.perf_counter()
            h = sess.serve(len(prompts), max_len, **kw)
            logits = h.prefill(dict(extra or {}, tokens=prompts))
            steps = [logits[:, -1]]
            tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
            toks = [tok]
            for _ in range(new_tokens - 1):
                tok, lg = h.decode(tok)
                toks.append(tok)
                steps.append(lg[:, -1])
            runs[name] = (torch.cat(toks, 1).cpu(), torch.stack(steps, 1).cpu())
            wall[name] = time.perf_counter() - t0
            sess._serve.clear()
            del h, logits, steps
        torch.cuda.empty_cache()
        ref_tokens, ref_logits = runs["dense_cached"]
        top2 = ref_logits.topk(2, dim=-1).values
        for name, (toks, _) in runs.items():
            if not torch.equal(toks, ref_tokens):
                row, step = (toks != ref_tokens).nonzero()[0].tolist()
                fail(f"{what}: {name} differs from dense_cached at slot {row} step {step} "
                     f"(top-2 margin there {top2[row, step, 0] - top2[row, step, 1]})")
        return runs, (top2[..., 0] - top2[..., 1]).min().item(), wall

    t_f32 = time.perf_counter()
    s32 = Session.init("bert-base", smoke=False, seed=SEED, dtype="float32")
    zero_counts()
    runs, min_margin, _ = greedy_runs("float32 token parity", s32, prompts, MAX_LEN,
                                      NEW_TOKENS)
    f32_counts = read_counts()
    emit(phase="parity", dtype="float32", runs=sorted(runs), identical=True,
         tokens=NEW_TOKENS, min_top2_margin=min_margin, launches=f32_counts,
         wall_s=time.perf_counter() - t_f32)
    if (f32_counts["mpo_linear_fwd_mma"] == 0 or f32_counts["mpo_linear_fwd"]
            or any(f32_counts[k] for k in plains)):
        fail(f"float32 bert-base serving: launches {f32_counts}; the tensor-core kernel must "
             "run, csrc/mpo_linear.cu and the plain versions not")
    f32_mma = {"bert-base float32 serve (three runs)": f32_counts["mpo_linear_fwd_mma"]}
    f32_flash = {"bert-base float32 serve (two paged runs)": f32_counts["flash_decode_attention"]}
    cuda_core = {}
    del s32, runs

    t_f32 = time.perf_counter()
    m32 = Session.init("mamba2-130m", smoke=False, seed=SEED, dtype="float32")
    # teacher-forced: both runs decode the weight-cached run's greedy tokens,
    # so every step compares the two on the same inputs.  Logits within
    # F32_TIE give the same greedy token wherever the top-2 margin exceeds
    # twice their difference; a closer tie is float32's summation order's to
    # decide, and is reported
    zero_counts()
    handles = {wc: m32.serve(MAMBA_BATCH, MAMBA_MAX_LEN, weight_cache=wc) for wc in (False, True)}
    last = {wc: h.prefill({"tokens": mprompts})[:, -1] for wc, h in handles.items()}
    steps = {wc: [v] for wc, v in last.items()}
    toks = []
    for i in range(NEW_TOKENS):
        tok = torch.argmax(last[True], -1)[:, None].to(torch.int32)
        toks.append(tok)
        if i < NEW_TOKENS - 1:
            for wc, h in handles.items():
                last[wc] = h.decode(tok)[1][:, -1]
                steps[wc].append(last[wc])
    toks = torch.cat(toks, 1).cpu()
    mruns = {wc: (toks, torch.stack(v, 1).cpu()) for wc, v in steps.items()}
    del handles, last, steps
    f32_counts = read_counts()
    emit(phase="parity", arch="mamba2-130m", dtype="float32", launches=f32_counts,
         wall_s=time.perf_counter() - t_f32)
    if (f32_counts["mpo_linear_fwd_mma"] == 0 or f32_counts["mpo_linear_fwd"]
            or any(f32_counts[k] for k in plains)):
        fail(f"float32 mamba2-130m serving: launches {f32_counts}; the tensor-core kernel "
             "must run, csrc/mpo_linear.cu and the plain versions not")
    f32_mma["mamba2-130m float32 serve (both runs)"] = f32_counts["mpo_linear_fwd_mma"]
    f32_ssd = {"mamba2-130m float32 serve (both runs)": f32_counts["ssd_scan"]}
    if f32_counts["ssd_scan"] != 2 * mcfg.num_layers:
        fail(f"float32 mamba2-130m serving: {f32_counts['ssd_scan']} SSD-scan launches in two "
             f"prefills (expected {2 * mcfg.num_layers})")
    cached, factorized = mruns[True][1], mruns[False][1]
    top2 = cached.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]                          # (slot, step)
    diff = (cached - factorized).abs().amax(dim=(0, 2))           # (step,)
    mscale = cached.abs().max().item()
    differs = cached.argmax(-1) != factorized.argmax(-1)
    ties = [[r, c, margin[r, c].item(), diff[c].item()] for r, c in differs.nonzero().tolist()]
    emit(phase="parity", arch="mamba2-130m", dtype="float32", runs=["cached", "factorized"],
         teacher_forced=True, tokens=NEW_TOKENS, logits_max_abs_diff=diff.max().item(),
         scale=mscale, tol=F32_TIE, min_top2_margin=margin.min().item(),
         argmax_differs_at=ties)
    if not diff.max().item() <= F32_TIE * mscale:
        fail(f"float32 mamba2-130m: the factorized run's logits differ from the weight-cached "
             f"run's by {diff.max().item()} > {F32_TIE} x {mscale}")
    for wc in (True, False):       # phase 3's bf16 prefill logits against float32's
        ref = mruns[wc][1][:, 0]
        got = mamba_logits[wc][:, -1].cpu()
        emit(phase="parity", arch="mamba2-130m", weight_cache=wc,
             bf16_vs_f32_prefill_logits_max_abs_diff=(got - ref).abs().max().item(),
             scale=ref.abs().max().item(),
             bf16_vs_f32_prefill_logits_rel_norm=((got - ref).norm() / ref.norm()).item())
    del m32, mruns

    def f32_routes(params, train, tied_head=False):
        """The forward kernels the float32 plan sends this model's factorized
        matmuls to: serving, every matrix as x @ W and the tied logits as
        x @ E^T; the classification train step, every matrix but the
        embedding (looked up, not multiplied) as x @ W and its i/j-swapped
        form (dL/dx); the LM train step of a tied head (``tied_head``) also
        x @ E^T and its dL/dx, dy @ E."""
        routes = set()
        tied = "lm_head" not in params      # an untied embedding is only looked up

        def walk(tree, name):
            if "cores" in tree:
                sh = [tuple(c.shape[-4:]) for c in cores_to_list(tree["cores"])]
                swap = [(d0, j, i, d1) for d0, i, j, d1 in sh]
                if name == "embed":
                    forms = ((swap, sh) if tied_head else ()) if train else (
                        (swap,) if tied else ())
                else:
                    forms = (sh, swap) if train else (sh,)
                routes.update(FWD_KERNEL[MK.forward_kernel(f, "float32")] for f in forms)
                return
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, k)

        walk(params, "")
        return routes

    def gate_routes(what, counts, params, train, tied_head=False):
        """Each forward kernel the float32 plan names launched, the other
        not; returns ``{kernel: launches}``."""
        want = f32_routes(params, train, tied_head)
        got = {k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_fwd")}
        if any((got[k] > 0) != (k in want) for k in got) or any(counts[k] for k in plains):
            fail(f"{what}: launches {counts}; the float32 plan sends its matrices to "
                 f"{sorted(want)}")
        return got

    # the smoke models, every MPO matmul in the kernel mode: card vs CPU
    for arch, prompt, kw in (("bert-base", 12, dict(paged=True)), ("mamba2-130m", 32, {})):
        smoke = {}
        for device in ("cuda", "cpu"):
            ss = Session.init(kernel_mode(configs.smoke_config(arch)), seed=SEED,
                              device=device)
            small = np.random.default_rng(SEED).integers(0, ss.cfg.vocab_size, (4, prompt))
            zero_counts()
            h = ss.serve(4, prompt + 20, weight_cache=False, **kw)
            logits = h.prefill({"tokens": small}).float().cpu()
            toks = h.generate({"tokens": small}, 8).cpu()
            smoke[device] = (logits, toks)
            if device == "cuda":
                got = gate_routes(f"smoke {arch} (float32) on the card", read_counts(),
                                  ss.params, train=False)
                f32_mma[f"smoke {arch} serve"] = got["mpo_linear_fwd_mma"]
                cuda_core[f"smoke {arch} serve"] = got["mpo_linear_fwd"]
        sdiff = (smoke["cuda"][0] - smoke["cpu"][0]).abs().max().item()
        sscale = smoke["cpu"][0].abs().max().item()
        emit(phase="parity", smoke=arch, mode="kernel", card_vs_cpu_logits_diff=sdiff,
             scale=sscale, tol=SMOKE_TOL, launches_on_card=got,
             tokens_identical=torch.equal(*[smoke[d][1] for d in smoke]))
        if sdiff > SMOKE_TOL * sscale or not torch.equal(smoke["cuda"][1], smoke["cpu"][1]):
            fail(f"smoke {arch} on the card differs from the CPU: logits {sdiff}, tokens "
                 f"{smoke['cuda'][1].tolist()} vs {smoke['cpu'][1].tolist()}")

    # ---- 5. training ----
    from repro_torch.data.pipeline import SyntheticCLS
    from repro_torch.optim import optimizers as OPT
    from repro_torch.train import steps as TS

    bwd_lib = MK._bwd_lib()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def bwd_case(mname, cores32, m, dtype, phase="train", dw_gate=True, tol=None):
        """The cores backward against its plain version: within ``TOL`` (or
        ``tol`` where more rows are summed than it was set for), two
        launches bit-identical, a call with the central core skipped (what
        ``freeze_central_grads`` asks) giving the other cores the same bits;
        the plan's shared memory and workspace equal to the CUDA source's,
        and (``dw_gate``: bert-base's matrices) the workspace below an f32
        dW, which at bond 128 it passes (PERF.md, row 2E)."""
        tdt = getattr(torch, dtype)
        cores = [c.to(tdt).contiguous() for c in cores32]
        i_dim = math.prod(c.shape[1] for c in cores)
        j_dim = math.prod(c.shape[2] for c in cores)
        x = torch.randn(m, i_dim, generator=gen).to(dev, tdt)
        dy = torch.randn(m, j_dim, generator=gen).to(dev, tdt)
        got = MK.mpo_linear_bwd_cores(cores, x, dy)
        again = MK.mpo_linear_bwd_cores(cores, x, dy)
        central = len(cores) // 2
        some = MK.mpo_linear_bwd_cores(cores, x, dy, [k != central for k in range(len(cores))])
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"mpo_linear_bwd_cores {mname} M={m} {dtype}: two runs differ")
        if some[central] is not None or not all(
                torch.equal(a, b) for k, (a, b) in enumerate(zip(some, got)) if k != central):
            fail(f"mpo_linear_bwd_cores {mname} M={m} {dtype}: the call without core "
                 f"{central} differs from the full call")
        ref = MK.mpo_linear_bwd_cores_plain(cores, x, dy)
        tol = TOL[dtype] if tol is None else tol
        err = max(check("mpo_linear_bwd_cores", g, r, dtype, f"{mname} M={m} {dtype} core {k}",
                        tol) for k, (g, r) in enumerate(zip(got, ref)))
        rel = max(((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                  for g, r in zip(got, ref))

        def library():
            cs = [c.detach().requires_grad_() for c in cores]
            return torch.autograd.grad(x @ mpo.reconstruct(cs), cs, dy)

        shapes = tuple(tuple(c.shape) for c in cores)
        plan = MK._bwd_plan(shapes, dtype, sms)
        dims = (ctypes.c_int * (4 * len(cores)))(*[d for sh in shapes for d in sh])
        ws_c = 4 * bwd_lib.mpo_linear_bwd_workspace(dims, len(cores), plan.split,
                                                    plan.blocks // plan.cluster, 1)
        smem_c = bwd_lib.mpo_linear_bwd_smem(dims, len(cores), plan.split, plan.tr, plan.tc,
                                             MK.DTYPES[tdt])
        if (smem_c, ws_c) != (plan.smem, plan.workspace):
            fail(f"mpo_linear_bwd_cores {mname} {dtype}: the plan's shared memory / workspace "
                 f"{plan.smem} / {plan.workspace} differ from the CUDA source's {smem_c} / {ws_c}")
        if dw_gate and plan.workspace >= 4 * i_dim * j_dim:
            fail(f"mpo_linear_bwd_cores {mname} {dtype}: workspace {plan.workspace} B is not "
                 f"below an f32 dW's {4 * i_dim * j_dim} B")
        ds = cores[plan.split].shape[0]
        isz = x.element_size()
        ncore = sum(c.numel() for c in cores)
        nbytes = isz * (x.numel() + dy.numel() + 2 * ncore)
        ops = 2 * m * i_dim * j_dim + 4 * ds * i_dim * j_dim   # x^T dy, then dL and dR
        rec = dict(kernel="mpo_linear_bwd_cores", matrix=mname,
                   shapes=[list(c.shape) for c in cores], M=m, dtype=dtype, split=plan.split,
                   tile=[plan.tr, plan.tc], tiles=plan.tiles, blocks=plan.blocks,
                   cluster=plan.cluster, smem_bytes=plan.smem,
                   launches_per_call=MK.BWD_KERNELS, workspace_bytes=plan.workspace,
                   dense_dw_f32_bytes=4 * i_dim * j_dim,
                   max_abs_err=err, max_rel_err=rel, tol=tol, deterministic=True,
                   kernel_ms=timed(lambda: MK.mpo_linear_bwd_cores(cores, x, dy)),
                   plain_ms=timed(lambda: MK.mpo_linear_bwd_cores_plain(cores, x, dy)),
                   library_ms=timed(library),
                   bound_ms=1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]),
                   bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_OPS_S[dtype]
                   else "operations")
        emit(phase=phase, **rec)
        return rec

    tokens = TRAIN_BATCH * TRAIN_SEQ
    for mname, cores32 in mats.items():
        for m in (37, tokens):
            for dtype in ("bfloat16", "float32"):
                results[("bwd", mname, m, dtype)] = bwd_case(mname, cores32, m, dtype)
    # the forward kernel at the training size, over W (the forward and its
    # recomputation under remat) and over the i/j-swapped cores of W^T (dL/dx)
    for mname, cores32 in mats.items():
        for form, cs in (("W", cores32), ("W^T", mpo.transpose_cores(cores32))):
            for dtype in ("bfloat16", "float32"):
                results[("mpo", mname, form, tokens, dtype)] = fwd_case(
                    f"{mname} {form}", cs, tokens, dtype, phase="train")

    # (b) full-width bert-base, LFA, on the card
    tsess = Session.init("bert-base", smoke=False, seed=SEED)
    central = {k: v.clone() for k, v in tsess.model.state_dict().items() if k.endswith(".central")}
    ft = dict(mode="lfa", seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, log_every=1)
    tsess.finetune(steps=1, seed=SEED + 1, **ft)            # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train_counters = counters + ((MK.mpo_linear_bwd_cores, "launches"),
                                 (MK.mpo_linear_bwd_cores_plain, "calls"))
    for fn, attr in train_counters:
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    rep = tsess.finetune(steps=TRAIN_STEPS, seed=SEED, **ft)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    tl = {"mpo_linear_fwd_mma": MK.mpo_linear_mma.launches,
          "mpo_linear_bwd_cores": MK.mpo_linear_bwd_cores.launches}
    plain = MK.mpo_linear_plain.calls + MK.mpo_linear_bwd_cores_plain.calls
    if MK.mpo_linear_cuda_core.launches:
        fail(f"fine-tuning (bf16): {MK.mpo_linear_cuda_core.launches} launches of the "
             "csrc/mpo_linear.cu forward")
    losses = [h["loss"] for h in rep["history"]]
    unchanged = all(torch.equal(v, tsess.model.state_dict()[k]) for k, v in central.items())
    emit(phase="train", arch="bert-base", dtype=tsess.cfg.dtype, mode="lfa", remat=tsess.cfg.remat,
         batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS,
         ms_per_step=1e3 * train_s / TRAIN_STEPS, tokens_per_s=tokens * TRAIN_STEPS / train_s,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         grad_norms=[h["grad_norm"] for h in rep["history"]],
         trainable=rep["trainable"], total=rep["total"], reduction=rep["reduction"],
         launches=tl, launches_per_step={k: v / TRAIN_STEPS for k, v in tl.items()},
         plain_calls=plain, central_cores=len(central), central_unchanged=unchanged)
    if min(tl.values()) == 0 or plain:
        fail(f"fine-tuning: kernel launches {tl}, plain-version calls {plain}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"fine-tuning: losses {losses}")
    if (rep["trainable"], rep["total"]) != LFA_COUNTS:
        fail(f"fine-tuning: {rep['trainable']} of {rep['total']} trainable, "
             f"expected {LFA_COUNTS}")
    if not central or not unchanged:
        fail("fine-tuning: a central core changed under LFA")
    path_launches["mpo_linear_fwd_mma"] += tl["mpo_linear_fwd_mma"]
    by_path["mpo_linear_fwd_mma"]["bert-base finetune lfa"] = tl["mpo_linear_fwd_mma"]
    path_launches["mpo_linear_bwd_cores"] = tl["mpo_linear_bwd_cores"]
    by_path["mpo_linear_bwd_cores"] = {"bert-base finetune lfa": tl["mpo_linear_bwd_cores"]}
    tsess.save(str(ana_tmp / "phase5"))        # phase 18 restores it
    del tsess

    # (c) the float32 smoke model in the kernel mode: card vs CPU
    def grads_and_losses(device):
        ss = Session.init(kernel_mode(configs.smoke_config("bert-base")), seed=SEED,
                          device=device)
        zero_counts()
        MK.mpo_linear_bwd_cores.launches = MK.mpo_linear_bwd_cores_plain.calls = 0
        seen = []
        rec_opt = OPT.Optimizer(init=lambda p: OPT.OptState(0, None),
                                update=lambda g, st, p: seen.append(g) or st)
        step = TS.make_train_step(ss.model, rec_opt, TS.make_cls_loss(ss.cfg))
        batch = SyntheticCLS(ss.cfg.vocab_size, 16, 4, seed=SEED).batch(0)
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        step(TS.TrainState(ss.params, rec_opt.init(ss.params)), batch)
        grads = [g.detach().cpu() for g in lightweight.leaves(seen[0])]
        hist = ss.finetune(steps=3, seq_len=16, batch_size=4, log_every=1)["history"]
        if device == "cuda":
            got = gate_routes("the float32 smoke train steps on the card", read_counts(),
                              ss.params, train=True)
            cuda_core["smoke bert-base train (4 steps)"] = got["mpo_linear_fwd"]
            f32_bwd["smoke bert-base train (4 steps)"] = MK.mpo_linear_bwd_cores.launches
            if not MK.mpo_linear_bwd_cores.launches or MK.mpo_linear_bwd_cores_plain.calls:
                fail(f"the float32 smoke train steps on the card: "
                     f"{MK.mpo_linear_bwd_cores.launches} cores-backward launches, "
                     f"{MK.mpo_linear_bwd_cores_plain.calls} plain-version calls")
        return grads, [h["loss"] for h in hist]

    f32_bwd = {}
    card, cpu = grads_and_losses("cuda"), grads_and_losses("cpu")
    gdiff = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(card[0], cpu[0]))
    ldiff = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    emit(phase="train", smoke="bert-base", mode="kernel", dtype="float32",
         card_vs_cpu_grad_rel_diff=gdiff, card_vs_cpu_loss_rel_diff=ldiff,
         losses_card=card[1], losses_cpu=cpu[1], tol=TRAIN_TOL,
         mpo_linear_bwd_cores_launches=f32_bwd)
    if not gdiff <= TRAIN_TOL or not ldiff <= TRAIN_TOL:
        fail(f"smoke train step on the card differs from the CPU: grads {gdiff}, "
             f"losses {card[1]} vs {cpu[1]}")

    # ---- 6. the lifecycle: from_dense -> finetune -> squeeze -> serve ----
    from repro_torch.core import squeeze as SQ
    from repro_torch.models import model as TMOD
    from repro_torch.models import transformer as TR

    def sync_clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    # (a) Algorithm 1, exact: the reconstructions of a random MPO init
    src = Session.init("bert-base", smoke=False, seed=SEED)
    dense = exact_dense(src.params)
    t0 = sync_clock()
    life = Session.from_dense(dense, src.cfg)
    from_dense_s = sync_clock() - t0
    rep = life.report()
    cfg32 = dataclasses.replace(src.cfg, dtype="float32")
    with torch.no_grad():
        ptok = torch.as_tensor(prompts, device=dev)
        l_src = TR.forward(src.params, {"tokens": ptok}, cfg32, phase="prefill").float()
        l_conv = TR.forward(life.params, {"tokens": ptok}, cfg32, phase="prefill").float()
    ldiff = (l_conv - l_src).abs().max().item()
    lscale = l_src.abs().max().item()
    emit(phase="lifecycle", step="from_dense exact", arch="bert-base",
         matrices=rep["stages"][-1]["matrices"], from_dense_s=from_dense_s,
         conversion_max_rel_err=rep["conversion_max_rel_err"],
         conversion_mean_rel_err=rep["conversion_mean_rel_err"], tol=EXACT_TOL,
         f32_prefill_logits_max_abs_diff=ldiff, scale=lscale, logits_tol=SMOKE_TOL,
         svd_driver=mpo.SVD_DRIVER)
    if not rep["conversion_max_rel_err"] <= EXACT_TOL:
        fail(f"from_dense of an exact tree: conversion error {rep['conversion_max_rel_err']}")
    if not ldiff <= SMOKE_TOL * lscale:
        fail(f"from_dense of an exact tree: float32 prefill logits differ by {ldiff} > "
             f"{SMOKE_TOL} x {lscale} from the source model's")
    del src, dense, l_src, l_conv

    # (b) Algorithm 1, truncated: the port's dense build (full-rank Gaussian)
    dcfg = dataclasses.replace(life.cfg, mpo=dataclasses.replace(life.cfg.mpo, enabled=False))
    dense = TMOD.build(dcfg, seed=SEED).tree()
    t0 = sync_clock()
    trunc = Session.from_dense(dense, life.cfg)
    trunc_s = sync_clock() - t0
    errs = eq4_errors(trunc.params, dense)
    worst = max(e["rel_err"] / e["bound"] for e in errs)
    emit(phase="lifecycle", step="from_dense truncated", arch="bert-base", from_dense_s=trunc_s,
         matrices_by_layer=len(errs), max_rel_err=max(e["rel_err"] for e in errs),
         mean_rel_err=sum(e["rel_err"] for e in errs) / len(errs),
         max_err_over_eq4_bound=worst, slack=EQ4_SLACK)
    if not worst <= 1 + EQ4_SLACK:
        fail(f"from_dense truncated: a matrix's error exceeds Eq. 4's bound by {worst}")
    del trunc, dense

    # (c) LFA on the converted session, through both MPO-linear kernels
    for fn, attr in train_counters:
        setattr(fn, attr, 0)
    t0 = sync_clock()
    ft = life.finetune(mode="lfa", steps=LIFE_STEPS, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                       seed=SEED, log_every=1)
    ft_s = sync_clock() - t0
    lt = {"mpo_linear_fwd_mma": MK.mpo_linear_mma.launches,
          "mpo_linear_bwd_cores": MK.mpo_linear_bwd_cores.launches}
    plain = MK.mpo_linear_plain.calls + MK.mpo_linear_bwd_cores_plain.calls
    rep = life.report()
    emit(phase="lifecycle", step="finetune lfa", steps=LIFE_STEPS, s=ft_s,
         losses=[h["loss"] for h in ft["history"]], launches=lt, plain_calls=plain,
         trainable=rep["trainable"], total=rep["params_total"],
         trainable_reduction=rep["trainable_reduction"])
    if min(lt.values()) == 0 or plain or MK.mpo_linear_cuda_core.launches:
        fail(f"lifecycle finetune: launches {lt}, plain-version calls {plain}")
    for k, v in lt.items():
        path_launches[k] += v
        by_path.setdefault(k, {})["bert-base lifecycle finetune lfa"] = v

    # (d) Algorithm 2: every iteration accepted (accuracy lies in [0, 1])
    engine = life.engine
    plans_before = planned_modes(engine, life.params, tokens, BATCH * PROMPT, BATCH)
    configured = {"/".join(p[:-1]): tuple(tuple(c.shape[-4:]) for c in cores_to_list(cd))
                  for p, cd in SQ.find_mpo_layers(life.params).items()}
    # a handle taken before the squeeze: its version only (the session drops
    # the handle itself when the squeeze bumps the weights version)
    pre_version = life.serve(BATCH, LIFE_MAX_LEN, paged=True).version
    clone = lambda p: lightweight.tree_map(lambda t: t.detach().clone(), p)
    # one accepted iteration a call (delta = 1.0 accepts every one), so the
    # tree each iteration chose from is the session's before the call; the
    # evaluations' launches (the baseline's and each iteration's) are
    # counted apart from the re-tunes'
    fwd_bwd = lambda: {"mpo_linear_fwd_mma": MK.mpo_linear_mma.launches,
                       "mpo_linear_bwd_cores": MK.mpo_linear_bwd_cores.launches}
    ev_launches = dict.fromkeys(fwd_bwd(), 0)

    def eval_counted(p):
        before = fwd_bwd()
        metric = life.evaluate(p, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH)
        for k, v in fwd_bwd().items():
            ev_launches[k] += v - before[k]
        return metric

    trees, events = [], []
    for fn, attr in train_counters:
        setattr(fn, attr, 0)
    t0 = sync_clock()
    for _ in range(LIFE_ITERS):
        trees.append(clone(life.params))
        events += life.squeeze(step=1, max_iters=1, finetune_steps=LIFE_STEPS,
                               seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, delta=1.0,
                               eval_fn=eval_counted)
    squeeze_s = sync_clock() - t0
    sq = {k: v - ev_launches[k] for k, v in fwd_bwd().items()}
    plain = MK.mpo_linear_plain.calls + MK.mpo_linear_bwd_cores_plain.calls
    if len(events) != LIFE_ITERS:
        fail(f"squeeze: {len(events)} events, expected {LIFE_ITERS}")
    for it, (ev, pre) in enumerate(zip(events, trees)):
        rc = check_event(ev, pre)
        emit(phase="lifecycle", step="squeeze iteration", iteration=it,
             layer="/".join(ev.layer[:-1]), bond=ev.bond, new_dim=ev.new_dim,
             predicted_error=ev.predicted_error, metric=ev.metric, seconds=ev.seconds, **rc)
    del trees
    stages = [r for r in life.report()["stages"] if r["stage"] == "squeeze"][-LIFE_ITERS:]
    rho_before, rho_after = stages[0]["rho_before"], stages[-1]["rho_after"]
    plans_after = planned_modes(engine, life.params, tokens, BATCH * PROMPT, BATCH)
    lost = {k: plans_after[k] for k, m in plans_before.items()
            if m == "kernel" and plans_after[k] != "kernel"}
    emit(phase="lifecycle", step="squeeze", arch="bert-base", s=squeeze_s, events=len(events),
         rho_before=rho_before, rho_after=rho_after,
         launches_in_retune=sq, launches_in_evaluations=ev_launches, plain_calls=plain,
         plans_kernel_before=sum(m == "kernel" for m in plans_before.values()),
         plans_kernel_after=sum(m == "kernel" for m in plans_after.values()),
         plans_after={f"{k[0]} {k[1]}": m for k, m in plans_after.items()})
    if not rho_after < rho_before:
        fail(f"squeeze: rho {rho_before} -> {rho_after} did not fall")
    if lost:
        fail(f"squeeze: matrices planned 'kernel' before and not after: {lost}")
    if min(sq.values()) == 0 or plain:
        fail(f"squeeze re-tune: launches {sq}, plain-version calls {plain}")
    for k, v in sq.items():
        path_launches[k] += v + ev_launches[k]
        by_path[k]["bert-base lifecycle squeeze re-tunes"] = v
        if ev_launches[k]:
            by_path[k]["bert-base lifecycle squeeze evaluations"] = ev_launches[k]
    # both kernels at every distinct squeezed core shape, against their plain
    # versions (the cases count no launches of the path)
    squeezed = {}
    for path, cd in SQ.find_mpo_layers(life.params).items():
        cores = [(c[0] if c.dim() == 5 else c).float() for c in cores_to_list(cd)]
        shape = tuple(tuple(c.shape) for c in cores)
        if shape != configured["/".join(path[:-1])]:
            squeezed.setdefault(shape, ("/".join(path[:-1]), cores))
    for shape, (mname, cores32) in squeezed.items():
        name = f"squeezed {mname} " + "x".join(str(c[3]) for c in shape[:-1])
        for form, cs in (("W", cores32), ("W^T", mpo.transpose_cores(cores32))):
            fwd_case(f"{name} {form}", [c.contiguous() for c in cs], tokens, "bfloat16",
                     phase="lifecycle")
        if MK._bwd_plan(shape, "bfloat16") is not None:
            bwd_case(name, cores32, tokens, "bfloat16", phase="lifecycle")
        elif mname != "embed":
            fail(f"the cores backward's plan refuses the squeezed {mname} {shape}")

    # (e) serve the squeezed model, with the weight cache and without
    life_logits = {}
    for wc in (True, False):
        handle, _, per_decode, life_logits[wc] = serve_run(
            life, "bert-base squeezed", prompts, LIFE_MAX_LEN,
            ("mpo_linear_fwd_mma", "flash_decode_attention"), paged=True, weight_cache=wc)
        if not handle.version > pre_version:
            fail(f"serve after squeeze: handle version {handle.version}, the pre-squeeze "
                 f"handle's {pre_version}")
        if per_decode["flash_decode_attention"] == 0:
            fail(f"serve after squeeze weight_cache={wc}: decode never launched flash")
        if wc:
            # the cached W: the squeezed cores' float32 contraction rounded
            # once to the activation dtype, bit for bit
            differ, dense_mats = [], 0
            for path, cd in SQ.find_mpo_layers(life.params).items():
                node = _at(handle.params, path[:-1])
                if "w" in node:
                    want = mpo.reconstruct_stacked(cores_to_list(cd)).to(life.cfg.torch_dtype)
                    dense_mats += 1
                    if not torch.equal(node["w"], want):
                        differ.append("/".join(path[:-1]))
            emit(phase="lifecycle", step="serve weight cache", densified=dense_mats,
                 dtype=life.cfg.dtype, cached_w_not_the_cores_contraction=differ)
            if dense_mats == 0 or differ:
                fail(f"serve after squeeze: {dense_mats} densified matrices, the cached W of "
                     f"{differ} is not the squeezed cores' contraction in {life.cfg.dtype}")
    diff = (life_logits[True] - life_logits[False]).abs().max().item()
    scale = life_logits[True].abs().max().item()
    emit(phase="lifecycle", step="serve", prefill_logits_max_abs_diff=diff, scale=scale,
         tol=PATH_TOL, report={k: v for k, v in life.report().items() if k != "stages"})
    if diff > PATH_TOL * scale:
        fail(f"serve after squeeze: prefill logits of the two runs differ by {diff}")
    del life, handle, life_logits

    # (f) cuSOLVER against LAPACK: the smoke model's exact conversion and
    # three squeeze moves, on the card and on the CPU
    scfg = configs.smoke_config("bert-base")
    sdense = exact_dense(Session.init(scfg, seed=SEED, device="cpu").params)
    runs = {}
    for device in ("cuda", "cpu"):
        ss = Session.from_dense(sdense, scfg, device=device)
        evs = ss.squeeze(finetune_steps=0, max_iters=3, delta=1.0, seq_len=16, batch_size=4)
        runs[device] = (evs, {p: mpo.reconstruct_stacked(cores_to_list(cd)).cpu()
                              for p, cd in SQ.find_mpo_layers(ss.params).items()})
    seq = {d: [(tuple(e.layer), e.bond, e.new_dim) for e in r[0]] for d, r in runs.items()}
    perr = max(abs(a.predicted_error - b.predicted_error) / b.predicted_error
               for a, b in zip(runs["cuda"][0], runs["cpu"][0]))
    squeezed_paths = {e[0] for e in seq["cpu"]}
    rdiff = max(((runs["cuda"][1][p] - r).abs().max() / r.abs().max()).item()
                for p, r in runs["cpu"][1].items() if p in squeezed_paths)
    emit(phase="lifecycle", step="card vs cpu", smoke="bert-base", sequence_card=seq["cuda"],
         sequence_cpu=seq["cpu"], predicted_error_max_rel_diff=perr,
         squeezed_reconstruction_max_rel_diff=rdiff, tol=CPU_TOL)
    if seq["cuda"] != seq["cpu"] or len(seq["cpu"]) != 3:
        fail(f"squeeze card vs cpu: {seq['cuda']} vs {seq['cpu']}")
    if not (perr <= CPU_TOL and rdiff <= CPU_TOL):
        fail(f"squeeze card vs cpu: predicted errors {perr}, reconstructions {rdiff}")

    # ---- 7. persistence: preempted and resumed, saved and restored ----
    from repro_torch.checkpoint import manager as CKM
    from repro_torch.resilience import faults as FLT
    from repro_torch.resilience.journal import SqueezeJournal

    def kernel_counts():
        return {"mpo_linear_fwd_mma": MK.mpo_linear_mma.launches,
                "mpo_linear_bwd_cores": MK.mpo_linear_bwd_cores.launches,
                "flash_decode_attention": DA.flash_decode_attention.launches,
                "ssd_scan": SSD.ssd_scan.launches}

    def plain_and_cuda_core():
        return (MK.mpo_linear_plain.calls + MK.mpo_linear_bwd_cores_plain.calls
                + DA.flash_decode_attention_plain.calls + SSD.ssd_scan_plain.calls
                + MK.mpo_linear_cuda_core.launches)

    def zero_all():
        for fn, attr in train_counters:
            setattr(fn, attr, 0)

    def fold(path, counts, need):
        """Fail unless every kernel of ``need`` launched and nothing else
        ran (plain versions, csrc/mpo_linear.cu); add the launches to the
        kernels line."""
        other = plain_and_cuda_core()
        if any(counts[k] == 0 for k in need) or other:
            fail(f"{path}: launches {counts}, plain-version or mpo_linear.cu calls {other}")
        for k, v in counts.items():
            if v:
                path_launches[k] = path_launches.get(k, 0) + v
                by_path.setdefault(k, {})[path] = v

    def params_of(sess):
        return {k: v.detach().clone() for k, v in sess.model.state_dict().items()}

    def same(p, q):
        return p.keys() == q.keys() and all(
            p[k].shape == q[k].shape and p[k].dtype == q[k].dtype
            and torch.equal(p[k], q[k].to(p[k].device)) for k in p)

    def dir_bytes(d):
        return sum(f.stat().st_size for f in Path(d).rglob("*") if f.is_file())

    def expect_raise(exc, fn, what):
        try:
            fn()
        except exc:
            return
        fail(f"{what} did not raise {exc.__name__}")

    p_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_persistence_"))
    try:
        # (a) fine-tuning checkpoint/resume: 8 LFA steps at 16 x 128
        ft = dict(mode="lfa", seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH, seed=SEED,
                  log_every=1)
        step_ms = {}
        tsess = Session.init("bert-base", smoke=False, seed=SEED)
        for name, kw in (("none", {}), ("every_2", dict(ckpt_dir=str(tmp / "every2"),
                                                        ckpt_every=2)), ("none_again", {})):
            t0 = sync_clock()
            tsess.finetune(steps=TRAIN_STEPS, **ft, **kw)
            step_ms[name] = 1e3 * (sync_clock() - t0) / TRAIN_STEPS
        kept = CKM.CheckpointManager(str(tmp / "every2")).all_steps()
        opt = OPT.adamw(2e-3, mask=lightweight.trainable_mask(tsess.params, mode="lfa"))
        st = TS.TrainState(tsess.params, opt.init(tsess.params))
        t0 = sync_clock()
        CKM._flatten(st)
        snapshot_s = sync_clock() - t0
        t0 = sync_clock()
        CKM.CheckpointManager(str(tmp / "one"), async_save=False).save(1, st, block=True)
        save_s = sync_clock() - t0
        save_bytes = dir_bytes(tmp / "one" / "step_1")
        del tsess, st, opt

        a = Session.init("bert-base", smoke=False, seed=SEED)
        a.finetune(steps=TRAIN_STEPS, ckpt_dir=str(tmp / "ft_a"), **ft)
        b = Session.init("bert-base", smoke=False, seed=SEED)
        with FLT.fault_scope(FLT.FaultPlan(preempt_finetune_step=4)):
            expect_raise(FLT.Preemption, lambda: b.finetune(
                steps=TRAIN_STEPS, ckpt_dir=str(tmp / "ft_b"), **ft), "preempted finetune")
        drained = CKM.CheckpointManager(str(tmp / "ft_b")).latest_step()
        zero_all()
        t0 = sync_clock()
        b.finetune(steps=TRAIN_STEPS, ckpt_dir=str(tmp / "ft_b"), **ft)
        resume_s = sync_clock() - t0
        counts = kernel_counts()
        fold("persistence bert-base finetune resumed", counts,
             ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))
        with np.load(tmp / "ft_a" / "step_8" / "arrays.npz") as za, \
                np.load(tmp / "ft_b" / "step_8" / "arrays.npz") as zb:
            keys = sorted(za.files)
            differ = [k for k in keys if not np.array_equal(za[k], zb[k])]
            opt_keys = sum(k.startswith(".opt_state/.inner/") for k in keys)
            same_keys = keys == sorted(zb.files)
        params_equal = same(params_of(a), params_of(b))
        emit(phase="persistence", step="finetune resume", arch="bert-base", dtype=b.cfg.dtype,
             batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=TRAIN_STEPS, preempted_at=4,
             latest_step_after_preemption=drained, resumed_s=resume_s,
             launches_resumed={k: counts[k] for k in ("mpo_linear_fwd_mma",
                                                       "mpo_linear_bwd_cores")},
             arrays=len(keys), optimizer_arrays=opt_keys, arrays_differing=differ,
             params_bit_identical=params_equal, save_s=save_s, snapshot_s=snapshot_s,
             save_bytes=save_bytes, ms_per_step=step_ms, ckpt_every_2_steps_kept=kept)
        if drained != 4:
            fail(f"preempted finetune: latest step {drained}, expected 4")
        if not same_keys or differ or not opt_keys or not params_equal:
            fail(f"finetune resume: arrays differing from the uninterrupted run {differ}, "
                 f"same keys {same_keys}, params bit-identical {params_equal}")
        del a

        # (b) the squeeze journal, phase 6's settings, three iterations
        sq = dict(step=1, max_iters=3, finetune_steps=LIFE_STEPS, seq_len=TRAIN_SEQ,
                  batch_size=TRAIN_BATCH, delta=1.0)
        u = Session.init("bert-base", smoke=False, seed=SEED)
        u.model.set_tree(clone(b.params))
        t0 = sync_clock()
        hist_u = u.squeeze(**sq)
        uninterrupted_s = sync_clock() - t0
        record_s, record = [], SqueezeJournal.record

        def timed_record(self, *args):
            t = sync_clock()
            record(self, *args)
            record_s.append(sync_clock() - t)

        SqueezeJournal.record = timed_record
        try:
            jdir = str(tmp / "journal")
            t0 = sync_clock()
            with FLT.fault_scope(FLT.FaultPlan(preempt_squeeze_iter=1)):
                expect_raise(FLT.Preemption, lambda: b.squeeze(ckpt_dir=jdir, **sq),
                             "preempted squeeze")
            preempted_s = sync_clock() - t0
            journaled = CKM.CheckpointManager(jdir).latest_step()
            zero_all()
            t0 = sync_clock()
            hist_b = b.squeeze(ckpt_dir=jdir, **sq)
            resumed_sq_s = sync_clock() - t0
        finally:
            SqueezeJournal.record = record
        counts = kernel_counts()
        fold("persistence bert-base squeeze resumed", counts,
             ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))
        tree_equal = same(params_of(u), params_of(b))
        rho = (SQ.model_compression_ratio(u.params), SQ.model_compression_ratio(b.params))
        emit(phase="persistence", step="squeeze journal", arch="bert-base", iterations=3,
             preempted_at=1, journal_latest_after_preemption=journaled,
             events=[("/".join(e.layer[:-1]), e.bond, e.new_dim, e.metric) for e in hist_b],
             history_equal=hist_b == hist_u, tree_bit_identical=tree_equal, rho=rho,
             record_s=record_s, uninterrupted_s=uninterrupted_s, preempted_s=preempted_s,
             resumed_s=resumed_sq_s,
             launches_resumed={k: counts[k] for k in ("mpo_linear_fwd_mma",
                                                       "mpo_linear_bwd_cores")})
        if journaled != 1 or len(hist_u) != 3 or hist_b != hist_u:
            fail(f"squeeze resume: journal at {journaled}, histories {hist_b} vs {hist_u}")
        if not tree_equal or rho[0] != rho[1]:
            fail(f"squeeze resume: tree bit-identical {tree_equal}, rho {rho}")
        del u

        # (c) Session.save / Session.restore of the squeezed session
        sdir = str(tmp / "session")
        t0 = sync_clock()
        b.save(sdir)
        sess_save_s = sync_clock() - t0
        sess_bytes = dir_bytes(sdir)
        t0 = sync_clock()
        r = Session.restore(sdir)
        restore_s = sync_clock() - t0
        # what the restore holds, read before serving adds a stage record
        state_equal = {
            "stage": r.stage == b.stage, "weights_version": r.weights_version == b.weights_version,
            "records": r._records == b._records, "mask": r.mask == b.mask,
            "squeeze_history": r.squeeze_history == b.squeeze_history,
            "conversion_report": r.conversion_report == b.conversion_report}
        first = torch.argmax(r.serve(BATCH, LIFE_MAX_LEN, paged=True)
                             .prefill({"tokens": prompts})[:, -1], -1)
        first_token_s = sync_clock() - t0
        saved_params = params_of(b)
        state_equal["leaves"] = same(params_of(r), saved_params)
        served = {}
        for wc in (True, False):
            want = b.serve(BATCH, LIFE_MAX_LEN, paged=True, weight_cache=wc).generate(
                {"tokens": prompts}, NEW_TOKENS)
            zero_all()
            got = r.serve(BATCH, LIFE_MAX_LEN, paged=True, weight_cache=wc).generate(
                {"tokens": prompts}, NEW_TOKENS)
            torch.cuda.synchronize()
            counts = kernel_counts()
            fold(f"persistence bert-base restored serve weight_cache={wc}", counts,
                 ("flash_decode_attention",) + (() if wc else ("mpo_linear_fwd_mma",)))
            served[f"weight_cache={wc}"] = dict(tokens_equal=torch.equal(got, want),
                                                first_token_equal=torch.equal(
                                                    first.int(), want[:, 0]) if wc else None,
                                                launches=counts)
        t0 = sync_clock()
        rc = Session.restore(sdir, device="cpu")
        cpu_restore_s = sync_clock() - t0
        cpu_equal = rc.device.type == "cpu" and same(params_of(rc), saved_params)
        del rc
        emit(phase="persistence", step="session save/restore", arch="bert-base",
             save_s=sess_save_s, restore_s=restore_s, restore_to_first_token_s=first_token_s,
             cpu_restore_s=cpu_restore_s, directory_mb=sess_bytes / 1e6, equal=state_equal,
             served=served, cpu_restore_bit_equal=cpu_equal)
        if not all(state_equal.values()) or not cpu_equal:
            fail(f"session restore: {state_equal}, cpu restore bit-equal {cpu_equal}")
        if not all(v["tokens_equal"] for v in served.values()) \
                or not served["weight_cache=True"]["first_token_equal"]:
            fail(f"restored session's greedy tokens differ: {served}")

        # (d) mamba2-130m: saved, restored, served cached
        ms = Session.init("mamba2-130m", smoke=False, seed=SEED)
        mdir = str(tmp / "mamba")
        t0 = sync_clock()
        ms.save(mdir)
        m_save_s = sync_clock() - t0
        t0 = sync_clock()
        mr = Session.restore(mdir)
        m_restore_s = sync_clock() - t0
        want = ms.serve(MAMBA_BATCH, MAMBA_MAX_LEN, weight_cache=True).generate(
            {"tokens": mprompts}, NEW_TOKENS)
        zero_all()
        got = mr.serve(MAMBA_BATCH, MAMBA_MAX_LEN, weight_cache=True).generate(
            {"tokens": mprompts}, NEW_TOKENS)
        torch.cuda.synchronize()
        counts = kernel_counts()
        fold("persistence mamba2-130m restored serve weight_cache=True", counts, ("ssd_scan",))
        m_equal = same(params_of(mr), params_of(ms))
        emit(phase="persistence", step="mamba2-130m save/restore", save_s=m_save_s,
             restore_s=m_restore_s, directory_mb=dir_bytes(mdir) / 1e6, leaves_equal=m_equal,
             tokens_equal=torch.equal(got, want), launches=counts)
        if not m_equal or not torch.equal(got, want):
            fail(f"mamba2-130m restore: leaves equal {m_equal}, tokens equal "
                 f"{torch.equal(got, want)}")
        del ms, mr

        # (e) crash consistency: a later save into (c)'s directory, crashed
        b.finetune(steps=1, **ft)                    # a later weights version
        crashes = {}
        for where in ("mid_write", "pre_latest"):
            with FLT.fault_scope(FLT.FaultPlan(crash_ckpt=where)):
                expect_raise(FLT.CrashPoint, lambda: b.save(sdir), f"crash at {where}")
            back = Session.restore(sdir)
            crashes[where] = (back.weights_version, same(params_of(back), saved_params))
        plan = FLT.FaultPlan(io_errors={"ckpt": 2})
        with FLT.fault_scope(plan):
            b.save(sdir)
        back = Session.restore(sdir)
        io_ok = (plan.io_errors["ckpt"] == 0 and back.weights_version == b.weights_version
                 and same(params_of(back), params_of(b)))
        emit(phase="persistence", step="crash consistency", first_save_version=r.weights_version,
             later_version=b.weights_version,
             restored_after_crash={k: {"version": v, "first_save_bits": e}
                                   for k, (v, e) in crashes.items()},
             io_errors_absorbed=io_ok)
        if any(v != r.weights_version or not e for v, e in crashes.values()) or not io_ok:
            fail(f"crash consistency: after crashes {crashes}, after I/O errors {io_ok}")
        del b, r, back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(phase="persistence", s=time.perf_counter() - p_t0)

    # ---- 8. the serving front end: ServePool, open-loop replay, PoolRouter ----
    from repro_torch.pipeline import traffic as TRF
    from repro_torch.pipeline.clock import VirtualClock, WallClock

    s_t0 = time.perf_counter()
    pool_kw = dict(paged=True, page_size=POOL_PAGE)
    bert_trace = TRF.make_trace(POOL_REQUESTS, 8.0, seed=SEED, prompt_len=(16, 128),
                                max_new=(8, 32), vocab_size=30720)
    mamba_trace = TRF.make_trace(8, 4.0, seed=SEED, prompt_len=(64, 512), max_new=(8, 16),
                                 vocab_size=50432)

    def pool_gate(path, counts, need):
        """Fail unless every kernel of ``need`` launched, and no plain version
        or mpo_linear.cu forward ran; add the launches to the kernels line."""
        other = sum(counts[k] for k in plains) + counts["mpo_linear_fwd"]
        if any(counts[k] == 0 for k in need) or other:
            fail(f"{path}: launches {counts}; {need} must launch, plain versions and the "
                 "mpo_linear.cu forward not")

    def fold_bf16(path, counts):
        for k in ("mpo_linear_fwd_mma", "flash_decode_attention", "ssd_scan"):
            if counts[k]:
                path_launches[k] = path_launches.get(k, 0) + counts[k]
                by_path.setdefault(k, {})[path] = counts[k]

    def open_loop(sess, path, trace, slots, max_len, need, **kw):
        """One open-loop replay of ``trace`` on the wall clock through a new
        pool: launch counts zeroed just before and read just after, peak
        memory from before the pool's build."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem_before = torch.cuda.memory_allocated()
        zero_counts()
        pool = sess.serve_pool(slots, max_len, **kw)
        clock = WallClock()
        pool.clock = clock                  # the replay's clock stamps submissions
        report = TRF.replay(pool, trace, clock=clock)
        torch.cuda.synchronize()
        counts = read_counts()
        st = pool.stats()
        rec = dict(report.summary, init_seconds=st["init_seconds"],
                   decode_toks_s=st["decode_toks_s"], prefill_toks_s=st["prefill_toks_s"],
                   occupancy=st["occupancy"], decode_steps=st["decode_steps"],
                   decode_ms_per_step=1e3 * st["decode_seconds"] / max(st["decode_steps"], 1),
                   admit_seconds=st["admit_seconds"], prefill_traces=st["prefill_traces"],
                   peak_mem_bytes=torch.cuda.max_memory_allocated(), mem_before_bytes=mem_before,
                   pool_peak_bytes=torch.cuda.max_memory_allocated() - mem_before,
                   launches={k: counts[k] for k in ("mpo_linear_fwd_mma",
                                                   "flash_decode_attention", "ssd_scan")},
                   plain_calls=sum(counts[k] for k in plains))
        emit(phase="serve_pool", run=path, arch=sess.cfg.name, dtype=sess.cfg.dtype,
             slots=slots, max_len=max_len, **kw, **rec)
        if report.summary["completed"] != len(trace):
            fail(f"{path}: {report.summary}")
        pool_gate(path, counts, need)
        fold_bf16(path, counts)
        return pool, report, rec, counts

    def parked_rows(pool, bcfg):
        """What parked rows add to a decode step: flash over the pool's
        geometry with one live slot (144 keys) and the others parked at the
        capacity sentinel (every page of the row walked, ids -1 read as page
        0), against the same call over the live row alone; the card's time
        of one layer's call, times the layers."""
        c = pool._cache
        kp, vp = c["k_pages"][0], c["v_pages"][0]
        mp = c["page_table"].shape[-1]
        cap = mp * POOL_PAGE
        q = torch.randn(POOL_SLOTS, bcfg.num_kv_heads, bcfg.num_heads // bcfg.num_kv_heads,
                        bcfg.head_dim, generator=gen).to(dev, kp.dtype)
        table = torch.full((POOL_SLOTS, mp), -1, dtype=torch.int32, device=dev)
        table[0, :9] = torch.arange(9, dtype=torch.int32, device=dev)
        lens = torch.full((POOL_SLOTS,), cap, dtype=torch.int32, device=dev)
        lens[0] = 144
        bias = torch.zeros(POOL_SLOTS, cap, device=dev)
        bias[0, 144:] = DA.MASK_VALUE
        full_ms = timed(lambda: DA.flash_decode_attention(q, kp, vp, table, lens, bias))
        live_ms = timed(lambda: DA.flash_decode_attention(
            q[:1].contiguous(), kp, vp, table[:1].contiguous(), lens[:1].clone(),
            bias[:1].contiguous()))
        emit(phase="serve_pool", parked_rows={
            "slots": POOL_SLOTS, "live": 1, "pages_a_row": mp, "flash_ms_all_rows": full_ms,
            "flash_ms_live_row": live_ms, "layers": bcfg.num_layers,
            "added_device_ms_per_step": bcfg.num_layers * (full_ms - live_ms)})

    # (a) bert-base, bf16, three admission modes; a throwaway replay first
    # takes the first-call costs out of the timed ones
    bsess = Session.init("bert-base", smoke=False, seed=SEED)
    warm = bsess.serve_pool(POOL_SLOTS, POOL_MAX_LEN, prefill_chunk=32, bucket_prompts=True,
                            **pool_kw)
    TRF.replay(warm, bert_trace[:4], clock=VirtualClock())
    del warm
    bert_runs = {}
    for name, kw in (("whole, weight cache", {}),
                     ("chunk 32 + bucket, weight cache",
                      dict(prefill_chunk=32, bucket_prompts=True)),
                     ("whole, factorized", dict(weight_cache=False))):
        need = ("flash_decode_attention",) + (
            ("mpo_linear_fwd_mma",) if kw.get("weight_cache") is False else ())
        pool, report, rec, _ = open_loop(bsess, f"bert-base bf16 pool: {name}", bert_trace,
                                         POOL_SLOTS, POOL_MAX_LEN, need, **kw, **pool_kw)
        bert_runs[name] = [r["tokens"] for r in report.records]
        if name == "whole, weight cache":
            parked_rows(pool, bsess.cfg)
        del pool                 # each run's peak memory is its own pool's
    agree = [np.array_equal(a, b) for a, b in zip(bert_runs["whole, weight cache"],
                                                   bert_runs["chunk 32 + bucket, weight cache"])]
    emit(phase="serve_pool", arch="bert-base", dtype="bfloat16",
         whole_vs_chunked_same_tokens=f"{sum(agree)}/{len(agree)}",
         phase3_decode_ms_per_step={"weight cache": decode_step_ms[("bert-base", True)],
                                    "factorized": decode_step_ms[("bert-base", False)]})
    del bsess

    # (b)-(d) float32: pool and fleet tokens against batch-1 serial generation
    def serial_run(sess, trace, max_len, **kw):
        """Batch-1 greedy tokens of every request (``ServeHandle``'s prefill
        and decode, as ``generate`` runs them), each step's logits kept."""
        h = sess.serve(1, max_len, **kw)
        out = []
        for r in trace:
            h.reset()
            logits = h.prefill({"tokens": r.prompt[None]})[:, -1]
            steps = [logits]
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            toks = [tok]
            for _ in range(r.max_new_tokens - 1):
                tok, lg = h.decode(tok)
                toks.append(tok)
                steps.append(lg[:, -1])
            out.append((torch.cat(toks, 1)[0].cpu().numpy(), torch.cat(steps, 0).float().cpu()))
        del h
        return out

    def tie_rule(path, got, serial):
        """Tokens equal serial generation; where they differ, the serial
        run's top-2 margin at the first differing step must lie within
        F32_TIE of that step's logits scale — a tie float32's summation order
        decides — and the request is compared no further."""
        ties, equal = [], 0
        for rid, (toks, want) in enumerate(zip(got, serial)):
            ref, logits = want
            if np.array_equal(toks, ref):
                equal += 1
                continue
            n = min(len(toks), len(ref))
            diff = np.nonzero(toks[:n] != ref[:n])[0]
            if diff.size == 0:
                fail(f"{path}: request {rid} has {len(toks)} tokens, serial {len(ref)}")
            step = int(diff[0])
            top2 = logits[step].topk(2).values
            margin, scale = (top2[0] - top2[1]).item(), logits[step].abs().max().item()
            ties.append({"request": rid, "step": step, "margin": margin, "scale": scale})
            if not margin <= F32_TIE * scale:
                fail(f"{path}: request {rid} differs from serial generation at step {step}, "
                     f"top-2 margin {margin} > {F32_TIE} x {scale}")
        return {"equal": equal, "requests": len(got), "ties": ties}

    f32_trace = bert_trace[:F32_REQUESTS]
    fsess = Session.init("bert-base", smoke=False, seed=SEED, dtype="float32")
    zero_counts()
    clock = VirtualClock()
    pool = fsess.serve_pool(POOL_SLOTS, POOL_MAX_LEN, clock=clock, **pool_kw)
    report = TRF.replay(pool, f32_trace, clock=clock)
    counts = read_counts()
    pool_gate("bert-base float32 pool", counts, ("flash_decode_attention",))
    f32_flash["bert-base float32 pool (phase 8)"] = counts["flash_decode_attention"]
    serial = serial_run(fsess, f32_trace, POOL_MAX_LEN, **pool_kw)
    parity = tie_rule("bert-base float32 pool", [r["tokens"] for r in report.records], serial)
    emit(phase="serve_pool", run="bert-base float32 pool, virtual clock", parity=parity,
         summary=report.summary, launches=counts)
    del pool

    # (d) a fleet of two replicas, fault-free and with a replica killed
    fleet_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    try:
        for name, plan in (("fault-free", FLT.FaultPlan()),
                           ("kill-pool:1:10", FLT.FaultPlan.parse(["kill-pool:1:10"]))):
            zero_counts()
            clock = VirtualClock()
            with FLT.fault_scope(plan):
                router = fsess.serve_fleet(2, FLEET_SLOTS, POOL_MAX_LEN, clock=clock,
                                           session_dir=str(fleet_dir / name.split(":")[0]),
                                           **pool_kw)
                report = TRF.replay(router, f32_trace, clock=clock, max_steps=20000)
            counts = read_counts()
            st = router.stats()
            rebuilt = [rep.pool for rep in router._replicas if rep.rebuilds]
            rebuilt_on = sorted({t.device.type for p in rebuilt
                                 for t in lightweight.leaves(p._sparams)})
            parity = tie_rule(f"fleet {name}", [r["tokens"] for r in report.records], serial)
            emit(phase="serve_pool", run=f"bert-base float32 fleet: {name}", parity=parity,
                 trips=st["trips"], rebuilds=st["rebuilds"], retries=st["retries"],
                 states=[r["state"] for r in st["replicas"]], rebuilt_params_on=rebuilt_on,
                 summary=report.summary, launches=counts)
            pool_gate(f"fleet {name}", counts, ("flash_decode_attention",))
            f32_flash[f"bert-base float32 fleet, {name} (phase 8)"] = counts[
                "flash_decode_attention"]
            if report.summary["completed"] != len(f32_trace):
                fail(f"fleet {name}: {report.summary}")
            if name == "fault-free" and st["trips"]:
                fail(f"the fault-free fleet tripped {st['trips']} times")
            if name != "fault-free" and (st["rebuilds"] < 1 or rebuilt_on != [dev.type]):
                fail(f"the killed fleet: {st['rebuilds']} rebuilds, rebuilt on {rebuilt_on}")
            del router
    finally:
        shutil.rmtree(fleet_dir, ignore_errors=True)

    # (e) flash-raise: the pool step raises, no plain version stands in
    pool = fsess.serve_pool(2, POOL_MAX_LEN, **pool_kw)
    pool.submit(f32_trace[0].prompt, 4)
    zero_counts()
    with FLT.fault_scope(FLT.FaultPlan(flash_raises=True)):
        expect_raise(FLT.InjectedKernelError, pool.step, "a pool step under flash-raise")
    counts = read_counts()
    emit(phase="serve_pool", run="flash-raise", raised="InjectedKernelError", launches=counts)
    if any(counts[k] for k in plains) or counts["flash_decode_attention"]:
        fail(f"flash-raise: launches {counts}; nothing may run in the kernel's place")
    del fsess, pool

    # (c) mamba2-130m: bf16 for the numbers, float32 for the tokens
    mb = Session.init("mamba2-130m", smoke=False, seed=SEED)
    _, _, rec, counts = open_loop(mb, "mamba2-130m bf16 pool: whole", mamba_trace, MAMBA_SLOTS,
                                  MAMBA_MAX_LEN, ("mpo_linear_fwd_mma", "ssd_scan"))
    if counts["ssd_scan"] != mb.cfg.num_layers * len(mamba_trace):
        fail(f"mamba2-130m pool: {counts['ssd_scan']} SSD-scan launches for "
             f"{len(mamba_trace)} admissions (expected {mb.cfg.num_layers} each)")
    del mb
    m32 = Session.init("mamba2-130m", smoke=False, seed=SEED, dtype="float32")
    zero_counts()
    clock = VirtualClock()
    pool = m32.serve_pool(MAMBA_SLOTS, MAMBA_MAX_LEN, clock=clock)
    report = TRF.replay(pool, mamba_trace, clock=clock)
    counts = read_counts()
    pool_gate("mamba2-130m float32 pool", counts, ("mpo_linear_fwd_mma", "ssd_scan"))
    f32_mma["mamba2-130m float32 pool (phase 8)"] = counts["mpo_linear_fwd_mma"]
    f32_ssd["mamba2-130m float32 pool (phase 8)"] = counts["ssd_scan"]
    parity = tie_rule("mamba2-130m float32 pool", [r["tokens"] for r in report.records],
                      serial_run(m32, mamba_trace, MAMBA_MAX_LEN))
    emit(phase="serve_pool", run="mamba2-130m float32 pool, virtual clock", parity=parity,
         summary=report.summary, launches=counts)
    del m32, pool
    emit(phase="serve_pool", s=time.perf_counter() - s_t0)

    # ---- 9. albert-base: from_dense -> LFA -> squeeze -> serve, saved and restored ----
    a_t0 = time.perf_counter()
    aprompts = np.random.default_rng(SEED + 2).integers(
        0, 30000, (BATCH, PROMPT)).astype(np.int32)          # albert's 30000 real ids
    # (a) Algorithm 1, exact (the reconstructions of a random MPO init) and
    # truncated (the port's dense build, full-rank Gaussian)
    src = Session.init("albert-base", smoke=False, seed=SEED)
    acfg = src.cfg
    dense = exact_dense(src.params)
    conv = {}
    t0 = sync_clock()
    alb = Session.from_dense(dense, acfg)
    conv["exact"] = sync_clock() - t0
    exact_errs = eq4_errors(alb.params, dense)
    rep = alb.report()
    a32 = dataclasses.replace(acfg, dtype="float32")
    with torch.no_grad():
        ptok = torch.as_tensor(aprompts, device=dev)
        l_src = TR.forward(src.params, {"tokens": ptok}, a32, phase="prefill").float()
        l_conv = TR.forward(alb.params, {"tokens": ptok}, a32, phase="prefill").float()
    ldiff, lscale = (l_conv - l_src).abs().max().item(), l_src.abs().max().item()
    del src, dense, l_src, l_conv
    dense = TMOD.build(dataclasses.replace(acfg, mpo=dataclasses.replace(acfg.mpo, enabled=False)),
                       seed=SEED).tree()
    t0 = sync_clock()
    trunc = Session.from_dense(dense, acfg)
    conv["truncated"] = sync_clock() - t0
    trunc_errs = eq4_errors(trunc.params, dense)
    worst = max(e["rel_err"] / e["bound"] for e in trunc_errs)
    emit(phase="albert", step="from_dense", from_dense_s=conv,
         exact={"matrices": rep["stages"][-1]["matrices"],
                "conversion_max_rel_err": rep["conversion_max_rel_err"],
                "max_eq4_bound": max(e["bound"] for e in exact_errs), "tol": EXACT_TOL,
                "f32_prefill_logits_max_abs_diff": ldiff, "scale": lscale,
                "logits_tol": SMOKE_TOL},
         truncated={"matrices_by_layer": len(trunc_errs),
                    "max_rel_err": max(e["rel_err"] for e in trunc_errs),
                    "max_eq4_bound": max(e["bound"] for e in trunc_errs),
                    "max_err_over_eq4_bound": worst, "slack": EQ4_SLACK})
    if not rep["conversion_max_rel_err"] <= EXACT_TOL or not ldiff <= SMOKE_TOL * lscale:
        fail(f"albert-base from_dense of an exact tree: error {rep['conversion_max_rel_err']}, "
             f"float32 prefill logits {ldiff} from the source model's (scale {lscale})")
    if not worst <= 1 + EQ4_SLACK:
        fail(f"albert-base from_dense truncated: an error exceeds Eq. 4's bound by {worst}")
    del trunc, dense

    # (b) LFA on the converted session: the one stored layer runs 12 times a
    # step, so the cores backward runs 12 times a matrix a step
    a_plans = planned_modes(alb.engine, alb.params, tokens, BATCH * PROMPT, BATCH)
    a_train = sum(m == "kernel" for (_, use), m in a_plans.items() if use == "train")
    central = {k: v.clone() for k, v in alb.model.state_dict().items() if k.endswith(".central")}
    zero_all()
    t0 = sync_clock()
    ft = alb.finetune(mode="lfa", steps=LIFE_STEPS, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH,
                      seed=SEED, log_every=1)
    ft_s = sync_clock() - t0
    counts = kernel_counts()
    want_bwd = LIFE_STEPS * acfg.num_layers * a_train
    unchanged = all(torch.equal(v, alb.model.state_dict()[k]) for k, v in central.items())
    emit(phase="albert", step="finetune lfa", steps=LIFE_STEPS, batch=TRAIN_BATCH,
         seq_len=TRAIN_SEQ, s=ft_s, ms_per_step=1e3 * ft_s / LIFE_STEPS,
         losses=[h["loss"] for h in ft["history"]], trainable=ft["trainable"], total=ft["total"],
         launches={k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores")},
         bwd_calls_expected=want_bwd, matrices_planned_kernel=a_train,
         central_unchanged=unchanged)
    fold("albert-base lifecycle finetune lfa", counts,
         ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))
    if (ft["trainable"], ft["total"]) != ALBERT_LFA_COUNTS:
        fail(f"albert-base LFA: {ft['trainable']} of {ft['total']} trainable, expected "
             f"{ALBERT_LFA_COUNTS}")
    if counts["mpo_linear_bwd_cores"] != want_bwd or not central or not unchanged:
        fail(f"albert-base LFA: {counts['mpo_linear_bwd_cores']} cores-backward calls, "
             f"expected {want_bwd}; central cores unchanged {unchanged}")
    if not all(math.isfinite(h["loss"]) for h in ft["history"]):
        fail(f"albert-base LFA: losses {[h['loss'] for h in ft['history']]}")

    # (c) Algorithm 2 at phase 6's settings: every iteration accepted
    a_ev = dict.fromkeys(fwd_bwd(), 0)

    def a_eval(p):
        before = fwd_bwd()
        metric = alb.evaluate(p, seq_len=TRAIN_SEQ, batch_size=TRAIN_BATCH)
        for k, v in fwd_bwd().items():
            a_ev[k] += v - before[k]
        return metric

    trees, events = [], []
    zero_all()
    t0 = sync_clock()
    for _ in range(LIFE_ITERS):
        trees.append(clone(alb.params))
        events += alb.squeeze(step=1, max_iters=1, finetune_steps=LIFE_STEPS, seq_len=TRAIN_SEQ,
                              batch_size=TRAIN_BATCH, delta=1.0, eval_fn=a_eval)
    squeeze_s = sync_clock() - t0
    counts = kernel_counts()
    retune = {k: counts[k] - a_ev[k] for k in a_ev}
    if len(events) != LIFE_ITERS:
        fail(f"albert-base squeeze: {len(events)} events, expected {LIFE_ITERS}")
    for it, (ev, pre) in enumerate(zip(events, trees)):
        emit(phase="albert", step="squeeze iteration", iteration=it,
             layer="/".join(ev.layer[:-1]), bond=ev.bond, new_dim=ev.new_dim,
             predicted_error=ev.predicted_error, metric=ev.metric, seconds=ev.seconds,
             **check_event(ev, pre))
    del trees
    stages = [r for r in alb.report()["stages"] if r["stage"] == "squeeze"][-LIFE_ITERS:]
    a_after = planned_modes(alb.engine, alb.params, tokens, BATCH * PROMPT, BATCH)
    lost = {k: a_after[k] for k, m in a_plans.items() if m == "kernel" and a_after[k] != "kernel"}
    want_bwd = LIFE_ITERS * LIFE_STEPS * acfg.num_layers * a_train
    emit(phase="albert", step="squeeze", s=squeeze_s, events=len(events),
         rho_before=stages[0]["rho_before"], rho_after=stages[-1]["rho_after"],
         launches_in_retune=retune, launches_in_evaluations=a_ev,
         bwd_calls_expected=want_bwd, plans_lost_kernel=lost)
    fold("albert-base lifecycle squeeze", counts, ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))
    if not stages[-1]["rho_after"] < stages[0]["rho_before"] or lost:
        fail(f"albert-base squeeze: rho {stages[0]['rho_before']} -> "
             f"{stages[-1]['rho_after']}, plans no longer kernel {lost}")
    if retune["mpo_linear_bwd_cores"] != want_bwd or a_ev["mpo_linear_bwd_cores"]:
        fail(f"albert-base squeeze: {retune['mpo_linear_bwd_cores']} cores-backward calls in "
             f"the re-tunes (expected {want_bwd}), {a_ev['mpo_linear_bwd_cores']} in evaluations")

    # (d) the squeezed model served in bf16, with the weight cache and without
    a_logits, a_tokens = {}, {}
    for wc in (True, False):
        handle, _, per_decode, a_logits[wc] = serve_run(
            alb, "albert-base squeezed", aprompts, MAX_LEN,
            ("mpo_linear_fwd_mma", "flash_decode_attention"), paged=True, weight_cache=wc)
        if per_decode["flash_decode_attention"] != acfg.num_layers * (NEW_TOKENS - 1):
            fail(f"albert-base weight_cache={wc}: {per_decode['flash_decode_attention']} flash "
                 f"launches in {NEW_TOKENS - 1} decode steps of {acfg.num_layers} layers")
        if wc:          # the cached W: the squeezed cores' contraction rounded once to bf16
            nodes = {p: _at(handle.params, p[:-1]) for p in SQ.find_mpo_layers(alb.params)}
            cached = {p: n["w"] for p, n in nodes.items() if "w" in n}
            differ = [p for p, w in cached.items() if not torch.equal(w, mpo.reconstruct_stacked(
                cores_to_list(SQ.find_mpo_layers(alb.params)[p])).to(acfg.torch_dtype))]
            if not cached or differ:
                fail(f"albert-base weight cache: {len(cached)} matrices cached, {differ} not "
                     "their cores' W in bf16")
        a_tokens[wc] = handle.generate({"tokens": aprompts}, NEW_TOKENS)
        alb._serve.clear()
        del handle
    diff = (a_logits[True] - a_logits[False]).abs().max().item()
    scale = a_logits[True].abs().max().item()
    emit(phase="albert", step="serve", prefill_logits_max_abs_diff=diff, scale=scale,
         tol=PATH_TOL, report={k: v for k, v in alb.report().items() if k != "stages"})
    if diff > PATH_TOL * scale:
        fail(f"albert-base: prefill logits of the two bf16 runs differ by {diff}")
    del a_logits

    # (e) float32 token parity on the squeezed tree (phase 4's three runs)
    s32 = Session.init(a32, seed=SEED)
    s32.model.set_tree(alb.params)
    zero_counts()
    _, margin, wall = greedy_runs("albert-base float32 token parity", s32, aprompts, MAX_LEN,
                                  NEW_TOKENS)
    counts = read_counts()
    emit(phase="albert", step="float32 parity", runs=sorted(wall), identical=True,
         min_top2_margin=margin, wall_s=wall, launches=counts)
    if (counts["mpo_linear_fwd_mma"] == 0 or counts["flash_decode_attention"] == 0
            or counts["mpo_linear_fwd"] or any(counts[k] for k in plains)):
        fail(f"albert-base float32 serving: launches {counts}")
    f32_mma["albert-base float32 serve (three runs)"] = counts["mpo_linear_fwd_mma"]
    f32_flash["albert-base float32 serve (two paged runs)"] = counts["flash_decode_attention"]
    del s32

    # (f) the squeezed session saved and restored on the card: the same tokens
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_albert_"))
    try:
        t0 = sync_clock()
        alb.save(str(tmp / "session"))
        save_s = sync_clock() - t0
        t0 = sync_clock()
        r = Session.restore(str(tmp / "session"))
        restore_s = sync_clock() - t0
        restored = {}
        for wc in (True, False):
            zero_all()
            got = r.serve(BATCH, MAX_LEN, paged=True, weight_cache=wc).generate(
                {"tokens": aprompts}, NEW_TOKENS)
            torch.cuda.synchronize()
            counts = kernel_counts()
            fold(f"albert-base restored serve weight_cache={wc}", counts,
                 ("flash_decode_attention",) + (() if wc else ("mpo_linear_fwd_mma",)))
            restored[f"weight_cache={wc}"] = torch.equal(got, a_tokens[wc])
        emit(phase="albert", step="save/restore", save_s=save_s, restore_s=restore_s,
             directory_mb=dir_bytes(tmp) / 1e6, leaves_equal=same(params_of(r), params_of(alb)),
             tokens_equal=restored)
        if not all(restored.values()) or not same(params_of(r), params_of(alb)):
            fail(f"albert-base restore: tokens equal {restored}")
        del r
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del alb
    torch.cuda.empty_cache()
    emit(phase="albert", s=time.perf_counter() - a_t0)

    # ---- 10. the dense LLM configurations at full width ----
    from repro_torch.core.engine import engine_for

    l_t0 = time.perf_counter()
    card_bytes = torch.cuda.get_device_properties(0).total_memory

    def reckon(cfg, batch, max_len):
        """Device bytes of a bf16 weight-cached handle, from the shapes
        alone (no weights drawn): the cached W in bf16 (every matrix whose
        decode plan is ``cached``), the float32 master weights, the KV cache."""
        with torch.device("meta"):
            params = TR.init(torch.Generator(), cfg)
        eng = engine_for(cfg.mpo)
        cached = 0
        for cd in SQ.find_mpo_layers(params).values():
            cores = cores_to_list(cd)
            if eng.plan(tuple(tuple(c.shape[-4:]) for c in cores), 1, "decode").mode == "cached":
                cached += 2 * math.prod(cores[0].shape[:-4]) * math.prod(
                    c.shape[-3] for c in cores) * math.prod(c.shape[-2] for c in cores)
        return {"cached_w_bf16_bytes": cached,
                "master_f32_bytes": 4 * sum(t.numel() for t in lightweight.leaves(params)),
                "kv_cache_bf16_bytes": 2 * 2 * cfg.num_layers * batch * max_len
                * cfg.num_kv_heads * cfg.head_dim}

    def llm_gate(what, counts, want):
        """Exactly the forward launches the engine's plans name, those over
        an expert stack among them, and no plain version."""
        got = {k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_fwd",
                                      "mpo_linear_fwd_mma_stacked", "mpo_linear_fwd_stacked")}
        if got != {k: want.get(k, 0) for k in got} or any(counts[k] for k in plains):
            fail(f"{what}: launches {counts}, the plans name {want}")

    lrng = np.random.default_rng(SEED + 3)
    for arch in LLM_ARCHS:
        cfg = configs.get_config(arch)
        rk = reckon(cfg, LLM_BATCH, LLM_MAX_LEN)
        emit(phase="llm", arch=arch, step="memory", card_bytes=card_bytes, **rk,
             sum_bytes=sum(rk.values()))
        lprompts = lrng.integers(0, cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)
        torch.cuda.empty_cache()
        t0 = sync_clock()
        sess = Session.init(cfg, seed=SEED)
        init_s = sync_clock() - t0
        # (a) bf16, full width and depth, the weight cache: flash the only kernel
        handle, _, per_decode, _ = serve_run(
            sess, arch, lprompts, LLM_MAX_LEN, ("mpo_linear_fwd_mma", "flash_decode_attention"),
            new_tokens=LLM_NEW, paged=True, weight_cache=True)
        cached = sum(_at(handle.params, p[:-1])["w"].numel() * 2
                     for p in SQ.find_mpo_layers(sess.params) if "w" in _at(handle.params, p[:-1]))
        peak = torch.cuda.max_memory_allocated()
        emit(phase="llm", arch=arch, step="weight cache", layers=cfg.num_layers, init_s=init_s,
             cache_weights_s=handle.init_seconds, cached_w_bytes=cached, peak_mem_bytes=peak,
             card_bytes=card_bytes, flash_per_decode_step=per_decode["flash_decode_attention"]
             / (LLM_NEW - 1))
        if cached != rk["cached_w_bf16_bytes"] or peak >= card_bytes:
            fail(f"{arch}: cached W {cached} B (reckoned {rk['cached_w_bf16_bytes']}), peak "
                 f"{peak} B on a card of {card_bytes}")
        if (per_decode["flash_decode_attention"] != cfg.num_layers * (LLM_NEW - 1)
                or per_decode["mpo_linear_fwd_mma"]):
            fail(f"{arch} weight cache: decode launches {per_decode}; flash once a layer a step "
                 "and nothing else")
        sess._serve.clear()
        del handle
        torch.cuda.empty_cache()
        # (a') the same model factorized: the forward on every matrix its plan
        # takes (at LLM_FACT_LAYERS' depth where full depth takes too long)
        if arch in LLM_FACT_LAYERS:
            del sess
            torch.cuda.empty_cache()
            sess = Session.init(dataclasses.replace(cfg, num_layers=LLM_FACT_LAYERS[arch]),
                                seed=SEED)
        depth = sess.cfg.num_layers
        modes, want = serve_plan(sess.engine, sess.params, sess.cfg, LLM_BATCH, LLM_PROMPT,
                                 "bfloat16")
        handle, per_prefill, per_decode, _ = serve_run(
            sess, arch if depth == cfg.num_layers else f"{arch} ({depth} layers)", lprompts,
            LLM_MAX_LEN, ("mpo_linear_fwd_mma", "flash_decode_attention"),
            new_tokens=LLM_NEW, paged=True, weight_cache=False)
        emit(phase="llm", arch=arch, step="factorized plans", layers=depth,
             depth_cut=depth != cfg.num_layers, modes=modes,
             launches_planned={k: {"prefill": v[0], "decode_step": v[1]}
                               for k, v in want.items()})
        llm_gate(f"{arch} factorized prefill", per_prefill, {k: v[0] for k, v in want.items()})
        llm_gate(f"{arch} factorized decode", per_decode,
                 {k: v[1] * (LLM_NEW - 1) for k, v in want.items()})
        sess._serve.clear()
        del handle, sess
        torch.cuda.empty_cache()
        # (b) float32, full width, LLM_F32_LAYERS layers (LLM_F32_DEPTH's cut):
        # tokens of three runs, decode logits against the teacher-forced forward
        f32_layers = LLM_F32_DEPTH.get(arch, LLM_F32_LAYERS)
        c32 = dataclasses.replace(cfg, dtype="float32", num_layers=f32_layers)
        s32 = Session.init(c32, seed=SEED)
        fb, fp = LLM_F32_PROMPT.get(arch, LLM_F32_SHORT)
        fprompts = lrng.integers(0, cfg.vocab_size, (fb, fp)).astype(np.int32)
        f_len = -(-(fp + LLM_F32_NEW) // POOL_PAGE) * POOL_PAGE
        zero_counts()
        runs, margin, wall = greedy_runs(f"{arch} float32 token parity", s32, fprompts, f_len,
                                         LLM_F32_NEW)
        counts = read_counts()
        _, want = serve_plan(s32.engine, s32.params, c32, fb, fp, "float32")
        llm_gate(f"{arch} float32 runs", counts,
                 {k: v[0] + v[1] * (LLM_F32_NEW - 1) for k, v in want.items()})
        if counts["flash_decode_attention"] != 2 * f32_layers * (LLM_F32_NEW - 1):
            fail(f"{arch} float32: {counts['flash_decode_attention']} flash launches in the two "
                 "paged runs")
        tree = s32.model.cache_weights(s32.params)
        seq = torch.cat([torch.as_tensor(fprompts), runs["dense_cached"][0][:, :-1]], 1).to(dev)
        with torch.no_grad():
            hidden = TR.forward_hidden(tree, {"tokens": seq}, c32, phase="prefill")
            tf = TR.logits_head(tree, hidden[:, fp - 1:], c32, phase="prefill").float().cpu()
        del tree, hidden
        terms = max(c32.d_ff, c32.d_model, c32.num_heads * c32.head_dim, fp + LLM_F32_NEW)
        tol = f32_tol(terms, f32_layers)
        tscale = tf.abs().max().item()
        tdiff = {name: (lg - tf).abs().max().item() for name, (_, lg) in runs.items()}
        emit(phase="llm", arch=arch, step="float32 parity", layers=f32_layers, batch=fb,
             prompt=fp, window=c32.local_window, new_tokens=LLM_F32_NEW, identical=True,
             min_top2_margin=margin, wall_s=wall,
             launches={k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_fwd",
                                              "flash_decode_attention")},
             teacher_forced_max_abs_diff=tdiff, scale=tscale, summed_terms=terms, tol=tol)
        if not max(tdiff.values()) <= tol * tscale:
            fail(f"{arch} float32: decode logits {tdiff} from the teacher-forced forward's "
                 f"(tol {tol} x {tscale})")
        for k, d in (("mpo_linear_fwd_mma", f32_mma), ("mpo_linear_fwd", cuda_core),
                     ("flash_decode_attention", f32_flash)):
            if counts[k]:
                d[f"{arch} float32 {f32_layers} layers (three runs)"] = counts[k]
        if arch == "gemma2-27b":
            # csrc/mpo_linear.cu at gemma2's FFN, where the float32 prefill
            # sends it: w_down sums d_ff = 36864 terms an output; at 64 rows
            # and at the long prompt's 4352
            wd = [c[0] for c in cores_to_list(s32.params["layers"]["mlp"]["w_down"]["cores"])]
            for m in (LLM_F32_CASE_M, fp):
                results[("mpo", arch, "w_down", m, "float32")] = fwd_case(
                    f"{arch} w_down", wd, m, "float32", phase="llm",
                    reps=1 if m == LLM_F32_CASE_M else 3, tol=f32_tol(c32.d_ff))
        if arch == "qwen3-14b":
            # csrc/mpo_linear.cu at qwen3's lm_head (5120 -> 152064: no bond's
            # js group tiles the tensor-core kernel's columns) at a float32
            # decode step's 2 rows
            results[("mpo", arch, "lm_head", 2, "float32")] = fwd_case(
                f"{arch} lm_head", cores_to_list(s32.params["lm_head"]["cores"]), 2, "float32",
                phase="llm", reps=3, tol=f32_tol(c32.d_model))
        del s32, runs
        torch.cuda.empty_cache()
    emit(phase="llm", s=time.perf_counter() - l_t0)

    # ---- 11. ssm_train: the SSD scan's backward; mamba2-130m fine-tuned and squeezed ----
    s_t0 = time.perf_counter()
    ssd_bwd_lib = SSD._bwd_lib()
    grad_names = ("dx", "ddt", "da_log", "db", "dc", "dd_skip")

    def ssd_bwd_case(bs, s, dtype, with_final, time_it, geom=None, phase="ssm_train"):
        """The backward kernel against its plain version from the same
        forward scratch: every gradient within ``SSD_BWD_TOL`` of its
        largest magnitude (by the gradient's dtype), two calls bit-identical,
        the plan's shared memory and scratch equal to the CUDA source's; when
        ``time_it``, the call, each of its four launches alone and the plain
        version timed, with the bound; at ``geom``'s geometry (mamba2-130m's
        when None)."""
        geom = geom or mcfg
        tdt = getattr(torch, dtype)
        h, p, n = geom.ssm_heads, geom.ssm_head_dim, geom.ssm_state
        x = torch.randn(bs, s, h, p, generator=gen).to(dev, tdt)
        dt = torch.nn.functional.softplus(torch.randn(bs, s, h, generator=gen) - 4).to(dev)
        a_log = (0.5 * torch.randn(h, generator=gen)).to(dev)
        b = (0.3 * torch.randn(bs, s, n, generator=gen)).to(dev, tdt)
        c = (0.3 * torch.randn(bs, s, n, generator=gen)).to(dev, tdt)
        d_skip = (1 + 0.1 * torch.randn(h, generator=gen)).to(dev)
        dy = torch.randn(bs, s, h, p, generator=gen).to(dev, tdt)
        d_final = torch.randn(bs, h, n, p, generator=gen).to(dev) if with_final else None
        args, chunk = (x, dt, a_log, b, c, d_skip), geom.ssm_chunk
        q = min(chunk, s)
        what = f"ssd_scan_bwd B={bs} S={s} {dtype} d_final={'random' if with_final else 'zero'}"
        fws = SSD._forward(*args, chunk)[2]
        got = SSD.ssd_scan_bwd(*args, dy, d_final, fws, chunk)
        again = SSD.ssd_scan_bwd(*args, dy, d_final, fws, chunk)
        torch.cuda.synchronize()
        if not all(torch.equal(u, v) for u, v in zip(got, again)):
            fail(f"{what}: two launches differ")
        ref = SSD.ssd_scan_bwd_plain(*args, dy, d_final, chunk)
        errs, rel = {}, {}
        for name, u, r in zip(grad_names, got, ref):
            tol = SSD_BWD_TOL["float32" if u.dtype == torch.float32 else "bfloat16"]
            errs[name] = check("ssd_scan_bwd", u, r, dtype, f"{what} {name}", tol=tol)
            rel[name] = errs[name] / r.float().abs().max().item()
        plan = SSD._ssd_bwd_plan(bs, s, h, p, n, q, dtype, MK._sm_count(0))
        code = SSD.DTYPES[tdt]
        smem_c = tuple(ssd_bwd_lib.ssd_scan_bwd_smem(k, q, n, p, plan.group, code)
                       for k in range(1, SSD.SSD_BWD_KERNELS + 1))
        ws_c = ssd_bwd_lib.ssd_scan_bwd_workspace(bs, s, h, p, n, q, plan.group)
        if (smem_c, ws_c) != (plan.smem, plan.workspace):
            fail(f"{what}: the plan's shared memory / scratch {plan.smem} / {plan.workspace} "
                 f"differ from the CUDA source's {smem_c} / {ws_c}")
        rec = dict(kernel="ssd_scan_bwd", B=bs, S=s, H=h, P=p, N=n, chunk=q, dtype=dtype,
                   d_final="random" if with_final else "zero",
                   max_abs_err=max(errs.values()), max_rel_err=rel, tol=SSD_BWD_TOL,
                   deterministic=True, group=plan.group, grids=list(plan.grids),
                   smem_bytes=list(plan.smem), workspace_bytes=plan.workspace,
                   forward_workspace_bytes=fws.numel() * 4,
                   launches_per_call=SSD.SSD_BWD_KERNELS)
        if time_it:
            ws = torch.empty(plan.workspace // 4, dtype=torch.float32, device=dev)
            grads = tuple(torch.empty_like(t) for t in args)
            stream = torch.cuda.current_stream().cuda_stream

            def run(k):
                return lambda: SSD._run_bwd(args, dy, d_final, fws, grads, ws, q, plan.group,
                                            stream, k)

            if run(0)() != 0:
                fail(f"{what}: the launches were refused")
            isz = x.element_size()
            # each input read once (x, dy, B, C, dt, a_log, D, d_final when
            # given), each gradient written once
            nbytes = (isz * (3 * x.numel() + 2 * b.numel() + 2 * c.numel())
                      + 4 * (2 * dt.numel() + 4 * h + (d_final.numel() if with_final else 0)))
            # C.B^T's causal half a chunk, d(C.B^T) times B and C; per head
            # dM = dy xw^T and M^T dy (causal halves), B dS and xw dS^T, and for
            # every chunk but the first C^T (e o dy) and dy prev^T
            tri, nc = q * (q + 1) // 2, s // q
            ops = 2 * bs * nc * 3 * tri * n + 2 * bs * h * (nc * (2 * tri * p + 2 * q * n * p)
                                                             + (nc - 1) * 2 * q * n * p)
            bound = {"bytes": nbytes / PEAK_BYTES_S, "operations": ops / PEAK_OPS_S[dtype]}
            rec.update(launch_ms=[timed(run(k)) for k in range(1, SSD.SSD_BWD_KERNELS + 1)],
                       kernel_ms=timed(lambda: SSD.ssd_scan_bwd(*args, dy, d_final, fws, chunk)),
                       plain_ms=timed(lambda: SSD.ssd_scan_bwd_plain(*args, dy, d_final,
                                                                     chunk)),
                       library_ms=None, bound_ms=1e3 * max(bound.values()),
                       bound_by=max(bound, key=bound.get),
                       tc_bound_ms=(1e3 * max(nbytes / PEAK_BYTES_S,
                                              6 * ops / PEAK_OPS_S["bfloat16"])
                                    if dtype == "float32" else None))
        emit(phase=phase, **rec)
        return rec

    # (a) the kernel at the training shape (4 x 512), phase 2's cases
    # (8 x 512, a 100-token chunk, 32 chunks), with and without a
    # final-state cotangent, both dtypes
    for dtype in ("bfloat16", "float32"):
        for (bs, s), name in (((SSM_BATCH, SSM_SEQ), "train"), ((MAMBA_BATCH, MAMBA_PROMPT), "path"),
                              ((MAMBA_BATCH, 100), "short"), ((1, 4096), "long")):
            for with_final in (True, False):
                rec = ssd_bwd_case(bs, s, dtype, with_final, time_it=with_final)
                if with_final:
                    results[("ssd_bwd", name, dtype)] = rec

    ssm_counters = train_counters + ((SSD.ssd_scan_bwd, "launches"),
                                     (SSD.ssd_scan_bwd_plain, "calls"))
    ssm_plains = ("mpo_linear_plain", "mpo_linear_bwd_cores_plain", "ssd_scan_plain",
                  "ssd_scan_bwd_plain")

    def ssm_zero():
        for fn, attr in ssm_counters:
            setattr(fn, attr, 0)

    def ssm_counts():
        return {"mpo_linear_fwd": MK.mpo_linear_cuda_core.launches,
                "mpo_linear_fwd_mma": MK.mpo_linear_mma.launches,
                "mpo_linear_bwd_cores": MK.mpo_linear_bwd_cores.launches,
                "ssd_scan": SSD.ssd_scan.launches, "ssd_scan_bwd": SSD.ssd_scan_bwd.launches,
                "mpo_linear_plain": MK.mpo_linear_plain.calls,
                "flash_decode_attention_plain": DA.flash_decode_attention_plain.calls,
                "mpo_linear_bwd_cores_plain": MK.mpo_linear_bwd_cores_plain.calls,
                "ssd_scan_plain": SSD.ssd_scan_plain.calls,
                "ssd_scan_bwd_plain": SSD.ssd_scan_bwd_plain.calls}

    def ssm_gate(path, counts, need):
        """Fail unless every kernel of ``need`` launched and no plain version
        (nor, in bf16, the mpo_linear.cu forward) ran; add the launches to the
        kernels line."""
        other = sum(counts[k] for k in ssm_plains) + counts["mpo_linear_fwd"]
        if any(counts[k] == 0 for k in need) or other:
            fail(f"{path}: launches {counts}, plain-version or mpo_linear.cu calls {other}")
        for k in ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores", "ssd_scan", "ssd_scan_bwd"):
            if counts[k]:
                path_launches[k] = path_launches.get(k, 0) + counts[k]
                by_path.setdefault(k, {})[path] = counts[k]

    # (b) the float32 smoke model, every matmul in the kernel mode: card vs CPU
    def ssm_grads_and_losses(device):
        ss = Session.init(kernel_mode(configs.smoke_config("mamba2-130m")), seed=SEED,
                          device=device)
        ssm_zero()
        seen = []
        rec_opt = OPT.Optimizer(init=lambda p: OPT.OptState(0, None),
                                update=lambda g, st, p: seen.append(g) or st)
        step = TS.make_train_step(ss.model, rec_opt, ss._default_loss_fn())
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in ss._default_batch_fn(16, 4, SEED)(0).items()}
        step(TS.TrainState(ss.params, rec_opt.init(ss.params)), batch)
        grads = [g.detach().cpu() for g in lightweight.leaves(seen[0])]
        hist = ss.finetune(steps=3, seq_len=16, batch_size=4, log_every=1)["history"]
        if device == "cuda":
            counts = ssm_counts()
            got = gate_routes("the float32 smoke mamba2-130m train steps on the card", counts,
                              ss.params, train=True, tied_head=True)
            cuda_core["smoke mamba2-130m train (4 steps)"] = got["mpo_linear_fwd"]
            f32_mma["smoke mamba2-130m train (4 steps)"] = got["mpo_linear_fwd_mma"]
            f32_bwd["smoke mamba2-130m train (4 steps)"] = counts["mpo_linear_bwd_cores"]
            f32_ssd["smoke mamba2-130m train (4 steps)"] = counts["ssd_scan"]
            f32_ssd_bwd["smoke mamba2-130m train (4 steps)"] = counts["ssd_scan_bwd"]
            if (not counts["ssd_scan_bwd"] or not counts["mpo_linear_bwd_cores"]
                    or any(counts[k] for k in ssm_plains)):
                fail(f"the float32 smoke mamba2-130m train steps on the card: {counts}")
        return grads, [h["loss"] for h in hist]

    f32_ssd_bwd = {}
    card, cpu = ssm_grads_and_losses("cuda"), ssm_grads_and_losses("cpu")
    gdiff = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(card[0], cpu[0]))
    ldiff = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
    emit(phase="ssm_train", smoke="mamba2-130m", mode="kernel", dtype="float32",
         leaves=len(card[0]), card_vs_cpu_grad_rel_diff=gdiff, card_vs_cpu_loss_rel_diff=ldiff,
         losses_card=card[1], losses_cpu=cpu[1], tol=TRAIN_TOL,
         ssd_scan_bwd_launches=f32_ssd_bwd)
    if not gdiff <= TRAIN_TOL or not ldiff <= TRAIN_TOL:
        fail(f"smoke mamba2-130m train step on the card differs from the CPU: grads {gdiff}, "
             f"losses {card[1]} vs {cpu[1]}")

    # (c) full-width mamba2-130m (bf16) through the paper's lifecycle
    msrc = Session.init("mamba2-130m", smoke=False, seed=SEED)
    mdense = exact_dense(msrc.params)
    t0 = sync_clock()
    ml = Session.from_dense(mdense, msrc.cfg)
    conv_s = sync_clock() - t0
    rep = ml.report()
    emit(phase="ssm_train", step="from_dense exact", arch="mamba2-130m",
         matrices=rep["stages"][-1]["matrices"], from_dense_s=conv_s,
         conversion_max_rel_err=rep["conversion_max_rel_err"], tol=EXACT_TOL)
    if not rep["conversion_max_rel_err"] <= EXACT_TOL:
        fail(f"mamba2-130m from_dense of an exact tree: error {rep['conversion_max_rel_err']}")
    del msrc, mdense

    ssm_tokens = SSM_BATCH * SSM_SEQ
    ft = dict(mode="lfa", seq_len=SSM_SEQ, batch_size=SSM_BATCH, log_every=1)
    central = {k: v.clone() for k, v in ml.model.state_dict().items() if k.endswith(".central")}
    ml.finetune(steps=1, seed=SEED + 1, **ft)            # warm-up, not counted
    ssm_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_clock()
    rep = ml.finetune(steps=SSM_STEPS, seed=SEED, **ft)
    ft_s = sync_clock() - t0
    counts = ssm_counts()
    losses = [h["loss"] for h in rep["history"]]
    unchanged = all(torch.equal(v, ml.model.state_dict()[k]) for k, v in central.items())
    # the cores backward's scratch at every matrix the step trains, against an f32 dW
    scratch = {}
    for path, cd in SQ.find_mpo_layers(ml.params).items():
        cores = [c[0] if c.dim() == 5 else c for c in cores_to_list(cd)]
        if path[0] == "embed":
            cores = mpo.transpose_cores(cores)
        shapes = tuple(tuple(c.shape) for c in cores)
        mode = ml.engine.plan(shapes, ssm_tokens, "train", "bfloat16", "cuda").mode
        plan = MK._bwd_plan(shapes, "bfloat16", sms)
        i_dim = math.prod(sh[1] for sh in shapes)
        j_dim = math.prod(sh[2] for sh in shapes)
        scratch["/".join(path[:-1])] = {
            "train_mode": mode, "workspace_bytes": plan.workspace if plan else None,
            "dense_dw_f32_bytes": 4 * i_dim * j_dim}
    per_step = {k: v / SSM_STEPS for k, v in counts.items()}
    emit(phase="ssm_train", step="finetune lfa", arch="mamba2-130m", dtype=ml.cfg.dtype,
         remat=ml.cfg.remat, batch=SSM_BATCH, seq_len=SSM_SEQ, steps=SSM_STEPS,
         ms_per_step=1e3 * ft_s / SSM_STEPS, tokens_per_s=ssm_tokens * SSM_STEPS / ft_s,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         trainable=rep["trainable"], total=rep["total"], reduction=rep["reduction"],
         launches=counts, launches_per_step=per_step, central_cores=len(central),
         central_unchanged=unchanged, cores_bwd_scratch=scratch)
    layers = ml.cfg.num_layers
    if len(losses) != SSM_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"mamba2-130m fine-tuning: losses {losses}")
    if not central or not unchanged:
        fail("mamba2-130m fine-tuning: a central core changed under LFA")
    if (rep["trainable"], rep["total"]) != MAMBA_LFA_COUNTS:
        fail(f"mamba2-130m fine-tuning: {rep['trainable']} of {rep['total']} trainable, "
             f"expected {MAMBA_LFA_COUNTS}")
    # remat: each layer's forward runs again in the backward
    if counts["ssd_scan_bwd"] != layers * SSM_STEPS or counts["ssd_scan"] != 2 * layers * SSM_STEPS:
        fail(f"mamba2-130m fine-tuning: {counts['ssd_scan_bwd']} SSD backward and "
             f"{counts['ssd_scan']} forward launches in {SSM_STEPS} steps, expected "
             f"{layers} and {2 * layers} a step")
    ssm_gate("mamba2-130m finetune lfa", counts, ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))

    # two squeeze iterations, one a call (delta = 1.0 accepts it), at 4 x 512
    plans_before = planned_modes(ml.engine, ml.params, ssm_tokens, MAMBA_BATCH * MAMBA_PROMPT,
                                 MAMBA_BATCH)
    rho0 = SQ.model_compression_ratio(ml.params)
    events, sq_counts = [], dict.fromkeys(ssm_counts(), 0)
    t0 = sync_clock()
    for _ in range(2):
        pre = lightweight.tree_map(lambda t: t.detach().clone(), ml.params)
        ssm_zero()
        evs = ml.squeeze(step=1, max_iters=1, finetune_steps=LIFE_STEPS, seq_len=SSM_SEQ,
                         batch_size=SSM_BATCH, delta=1.0)
        for k, v in ssm_counts().items():
            sq_counts[k] += v
        for ev in evs:
            rc = check_event(ev, pre)
            emit(phase="ssm_train", step="squeeze iteration", iteration=len(events),
                 layer="/".join(ev.layer[:-1]), bond=ev.bond, new_dim=ev.new_dim,
                 predicted_error=ev.predicted_error, metric=ev.metric, seconds=ev.seconds, **rc)
            events.append(ev)
        del pre
    sq_s = sync_clock() - t0
    rho1 = SQ.model_compression_ratio(ml.params)
    plans_after = planned_modes(ml.engine, ml.params, ssm_tokens, MAMBA_BATCH * MAMBA_PROMPT,
                                MAMBA_BATCH)
    lost = {k: plans_after[k] for k, m in plans_before.items()
            if m == "kernel" and plans_after[k] != "kernel"}
    emit(phase="ssm_train", step="squeeze", arch="mamba2-130m", s=sq_s, events=len(events),
         rho_before=rho0, rho_after=rho1, launches=sq_counts,
         plans_after={f"{k[0]} {k[1]}": m for k, m in plans_after.items()})
    if len(events) != 2 or not rho1 < rho0:
        fail(f"mamba2-130m squeeze: {len(events)} events, rho {rho0} -> {rho1}")
    if lost:
        fail(f"mamba2-130m squeeze: matrices planned 'kernel' before and not after: {lost}")
    if sq_counts["ssd_scan_bwd"] != 2 * LIFE_STEPS * layers:
        fail(f"mamba2-130m squeeze: {sq_counts['ssd_scan_bwd']} SSD backward launches in the "
             f"re-tunes, expected {2 * LIFE_STEPS * layers}")
    ssm_gate("mamba2-130m squeeze (re-tunes and evaluations)", sq_counts,
             ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))

    # the squeezed model served both ways from phase 3's prompts, under phase 3's gates
    for wc in (True, False):
        handle, per_prefill, per_decode, _ = serve_run(
            ml, "mamba2-130m squeezed", mprompts, MAMBA_MAX_LEN, ("mpo_linear_fwd_mma", "ssd_scan"),
            weight_cache=wc)
        if per_prefill["mpo_linear_fwd_mma"] == 0 or per_decode["mpo_linear_fwd_mma"] == 0:
            fail(f"squeezed mamba2-130m weight_cache={wc}: the head never launched "
                 "mpo_linear_fwd_mma")
        if per_prefill["ssd_scan"] != layers or per_decode["ssd_scan"]:
            fail(f"squeezed mamba2-130m weight_cache={wc}: {per_prefill['ssd_scan']} SSD-scan "
                 f"launches a prefill, {per_decode['ssd_scan']} in decode")
        layer_check(handle, wc, per_prefill)
    del ml, handle, central

    # a fine-tuning run preempted at step 4 and resumed, against one run through
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ssm_"))
    try:
        a = Session.init("mamba2-130m", smoke=False, seed=SEED)
        a.finetune(steps=SSM_STEPS, ckpt_dir=str(tmp / "a"), seed=SEED, **ft)
        b = Session.init("mamba2-130m", smoke=False, seed=SEED)
        with FLT.fault_scope(FLT.FaultPlan(preempt_finetune_step=4)):
            expect_raise(FLT.Preemption, lambda: b.finetune(
                steps=SSM_STEPS, ckpt_dir=str(tmp / "b"), seed=SEED, **ft), "preempted finetune")
        drained = CKM.CheckpointManager(str(tmp / "b")).latest_step()
        ssm_zero()
        t0 = sync_clock()
        b.finetune(steps=SSM_STEPS, ckpt_dir=str(tmp / "b"), seed=SEED, **ft)
        resume_s = sync_clock() - t0
        counts = ssm_counts()
        with np.load(tmp / "a" / f"step_{SSM_STEPS}" / "arrays.npz") as za, \
                np.load(tmp / "b" / f"step_{SSM_STEPS}" / "arrays.npz") as zb:
            keys = sorted(za.files)
            differ = [k for k in keys if not np.array_equal(za[k], zb[k])]
            same_keys = keys == sorted(zb.files)
        params_equal = same(params_of(a), params_of(b))
        emit(phase="ssm_train", step="finetune resume", arch="mamba2-130m", preempted_at=4,
             latest_step_after_preemption=drained, resumed_s=resume_s, launches_resumed=counts,
             arrays=len(keys), arrays_differing=differ, params_bit_identical=params_equal)
        if drained != 4:
            fail(f"mamba2-130m preempted finetune: latest step {drained}, expected 4")
        if not same_keys or differ or not params_equal:
            fail(f"mamba2-130m finetune resume: arrays differing {differ}, same keys "
                 f"{same_keys}, params bit-identical {params_equal}")
        if counts["ssd_scan_bwd"] != layers * (SSM_STEPS - 4):
            fail(f"mamba2-130m finetune resume: {counts['ssd_scan_bwd']} SSD backward launches")
        ssm_gate("mamba2-130m finetune resumed", counts,
                 ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))
        del a, b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(phase="ssm_train", s=time.perf_counter() - s_t0)

    # ---- 12. moe_vlm: expert stacks in one launch; llama4, phi3.5, llava ----
    v_t0 = time.perf_counter()
    moe_rows = moe_capacity
    # float32 stacked launches (tensor-core, mpo_linear.cu kernel) on the moe paths
    f32_stacked, f32_moe_core = {}, {}

    # (a) the stacked forward at every full-width expert shape of the paths:
    # llama4-maverick's w_up (5120 -> 8192) and w_down (8192 -> 5120), 128
    # experts, and phi3.5-moe's (4096 <-> 6400, 16 experts; the reference's
    # kernel refuses its w_up, ROADMAP.md Queue 3 H), each at a decode's and
    # a prefill's capacity rows an expert, both dtypes (w_gate has w_up's
    # shape); w_up timed at STACK_REPS calls, the others checked at one;
    # smoke phi3.5-moe's experts in float32 (csrc/mpo_linear.cu); flash at
    # llava-next-34b's geometry
    l4cfg, pcfg_full, vcfg = (configs.get_config(a) for a in MOE_ARCHS)
    for arch, cfg in ((LLAMA4, l4cfg), (PHI35, pcfg_full)):
        for name in ("w_up", "w_down"):
            stack = expert_cores(cfg, name)
            for m in (moe_rows(cfg, 1), moe_rows(cfg, LLM_PROMPT)):
                for dtype in ("bfloat16", "float32"):
                    # w_down sums over d_ff: f32_tol's rule for its float32 terms
                    results[("stacked", arch, name, m, dtype)] = fwd_case(
                        f"{arch} {name} ({cfg.num_experts} experts)", stack, m, dtype,
                        phase="moe_vlm", reps=STACK_REPS if name == "w_up" else 1,
                        tol=f32_tol(cfg.d_ff) if (dtype, name) == ("float32", "w_down")
                        else None)
            del stack
            torch.cuda.empty_cache()
    s_phi = configs.smoke_config(PHI35)
    for name in ("w_up", "w_gate", "w_down"):
        results[("stacked", "smoke", name)] = fwd_case(
            f"smoke {PHI35} {name}", expert_cores(s_phi, name), moe_rows(s_phi, 12, 4),
            "float32", phase="moe_vlm")
    for dtype in ("bfloat16", "float32"):
        results[("flash", LLAVA, dtype)] = flash_case(vcfg.num_kv_heads,
                                                      vcfg.num_heads // vcfg.num_kv_heads,
                                                      vcfg.head_dim, dtype, None, ragged)

    # (b) the smoke models, every MPO matmul in the kernel mode: card vs CPU
    for arch in MOE_ARCHS:
        smoke = {}
        for device in ("cuda", "cpu"):
            ss = Session.init(kernel_mode(configs.smoke_config(arch)), seed=SEED, device=device)
            srng = np.random.default_rng(SEED)
            batch = {"tokens": srng.integers(0, ss.cfg.vocab_size, (4, 12)).astype(np.int32)}
            if ss.cfg.family == "vlm":
                batch["patches"] = srng.normal(size=(4, ss.cfg.frontend_len,
                                                     ss.cfg.frontend_dim)).astype(np.float32)
            zero_counts()
            h = ss.serve(4, 48, paged=True, weight_cache=False)
            logits = h.prefill(batch).float().cpu()
            toks = h.generate(batch, 8).cpu()
            smoke[device] = (logits, toks)
            if device == "cuda":
                sc = read_counts()
                got = gate_routes(f"smoke {arch} (float32) on the card", sc, ss.params,
                                  train=False)
                for k, d in (("mpo_linear_fwd_mma", f32_mma), ("mpo_linear_fwd", cuda_core),
                             ("mpo_linear_fwd_mma_stacked", f32_stacked),
                             ("mpo_linear_fwd_stacked", f32_moe_core)):
                    if sc[k]:
                        d[f"smoke {arch} serve"] = sc[k]
                if (ss.cfg.family == "moe") != bool(sc["mpo_linear_fwd_mma_stacked"]
                                                    + sc["mpo_linear_fwd_stacked"]):
                    fail(f"smoke {arch} on the card: stacked launches {sc}")
        sdiff = (smoke["cuda"][0] - smoke["cpu"][0]).abs().max().item()
        sscale = smoke["cpu"][0].abs().max().item()
        emit(phase="moe_vlm", smoke=arch, mode="kernel", card_vs_cpu_logits_diff=sdiff,
             scale=sscale, tol=SMOKE_TOL, launches_on_card=got,
             tokens_identical=torch.equal(*[smoke[d][1] for d in smoke]))
        if sdiff > SMOKE_TOL * sscale or not torch.equal(smoke["cuda"][1], smoke["cpu"][1]):
            fail(f"smoke {arch} on the card differs from the CPU: logits {sdiff}, tokens "
                 f"{smoke['cuda'][1].tolist()} vs {smoke['cpu'][1].tolist()}")
        del ss, h

    def exact_launches(what, counts, sess, batch, prompt, dtype, runs):
        """Exactly the forward launches the engine's plans name over ``runs``
        (``[(weight_cache, decode steps)]``), and no plain version; returns
        the plans' modes."""
        want = {}
        for wc, steps in runs:
            modes, plan = serve_plan(sess.engine, sess.params, sess.cfg, batch, prompt, dtype,
                                     weight_cache=wc)
            for k, (pre, dec) in plan.items():
                want[k] = want.get(k, 0) + pre + dec * steps
        llm_gate(what, counts, want)
        return modes

    def moe_memory(cfg, batch, max_len, prompt):
        """``reckon``'s bytes, plus the paged prefill's attention transient:
        the scores of every head in bf16 twice (product, mask), in f32 twice
        (softmax in and out) and the bf16 weights, 14 bytes a score."""
        rk = reckon(cfg, batch, max_len)
        rk["prefill_attention_bytes"] = 14 * batch * cfg.num_heads * prompt * prompt
        return rk, sum(rk.values())

    # (c) llama4-maverick, bf16, full width, LLAMA4_FACT_LAYERS layers, factorized:
    # the stacked forward three launches a MoE layer a call
    cfg4 = dataclasses.replace(l4cfg, num_layers=LLAMA4_FACT_LAYERS)
    rk, total = moe_memory(cfg4, LLM_BATCH, LLM_MAX_LEN, LLM_PROMPT)
    emit(phase="moe_vlm", arch=LLAMA4, step="memory", layers=LLAMA4_FACT_LAYERS,
         card_bytes=card_bytes, **rk, sum_bytes=total)
    lp = lrng.integers(0, l4cfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)
    t0 = sync_clock()
    sess = Session.init(cfg4, seed=SEED)
    init_s = sync_clock() - t0
    modes, want = serve_plan(sess.engine, sess.params, cfg4, LLM_BATCH, LLM_PROMPT, "bfloat16")
    experts = {k: u for k, u in modes.items() if "/experts/" in k}
    if len(experts) != 3 or any(u != {"prefill": "kernel", "decode": "kernel"}
                                for u in experts.values()):
        fail(f"{LLAMA4}: the expert matrices plan {experts}, not the kernel in prefill and "
             "decode")
    handle, per_prefill, per_decode, _ = serve_run(
        sess, f"{LLAMA4} ({LLAMA4_FACT_LAYERS} layers)", lp, LLM_MAX_LEN,
        ("mpo_linear_fwd_mma", "flash_decode_attention"), new_tokens=LLM_NEW, paged=True,
        weight_cache=False)
    emit(phase="moe_vlm", arch=LLAMA4, step="factorized plans", layers=LLAMA4_FACT_LAYERS,
         init_s=init_s, modes=modes,
         expert_rows={"prefill": moe_rows(l4cfg, LLM_PROMPT), "decode": moe_rows(l4cfg, 1)},
         stacked_launches_per_call=len(experts) * LLAMA4_FACT_LAYERS,
         launches_planned={k: {"prefill": v[0], "decode_step": v[1]} for k, v in want.items()},
         workspace_bytes_last_call=MK.mpo_linear_mma.workspace_bytes)
    llm_gate(f"{LLAMA4} factorized prefill", per_prefill, {k: v[0] for k, v in want.items()})
    llm_gate(f"{LLAMA4} factorized decode", per_decode,
             {k: v[1] * (LLM_NEW - 1) for k, v in want.items()})
    # bf16 stacked launches on the moe paths, measured (llm_gate held them to
    # the plans) and planned: 3 a MoE layer a call
    st = "mpo_linear_fwd_mma_stacked"
    moe_paths = {f"{LLAMA4} serve weight_cache=False":
                 (per_prefill[st] + per_decode[st],
                  len(experts) * LLAMA4_FACT_LAYERS * LLM_NEW)}
    sess._serve.clear()
    del handle, sess
    torch.cuda.empty_cache()
    # float32, 1 layer: every decode step's logits against the teacher-forced
    # forward's on the same tokens.  A capacity that binds drops tokens by the
    # length of the sequence routed (prefill, one decode token, the whole
    # teacher-forced sequence), so the check runs at capacity_factor = E,
    # where no expert can overflow and the three compute one function
    c32 = dataclasses.replace(l4cfg, dtype="float32", num_layers=1,
                              capacity_factor=float(l4cfg.num_experts))
    s32 = Session.init(c32, seed=SEED)
    fb, fp = LLM_F32_SHORT
    fprompts = lrng.integers(0, l4cfg.vocab_size, (fb, fp)).astype(np.int32)
    f_len = -(-(fp + LLAMA4_F32_NEW) // POOL_PAGE) * POOL_PAGE
    zero_counts()
    t0 = sync_clock()
    with torch.no_grad():
        h = s32.serve(fb, f_len, paged=True, weight_cache=False)
        lg = h.prefill({"tokens": fprompts})[:, -1]
        steps, toks = [lg], [torch.argmax(lg, -1)[:, None].to(torch.int32)]
        for _ in range(LLAMA4_F32_NEW - 1):
            tok, lg = h.decode(toks[-1])
            toks.append(tok)
            steps.append(lg[:, -1])
        served_s = sync_clock() - t0
        counts = read_counts()
        exact_launches(f"{LLAMA4} float32 serve", counts, s32, fb, fp, "float32",
                       [(False, LLAMA4_F32_NEW - 1)])
        seq = torch.cat([torch.as_tensor(fprompts, device=dev), torch.cat(toks[:-1], 1)], 1)
        hidden = TR.forward_hidden(s32.params, {"tokens": seq}, c32, phase="prefill")
        tf = TR.logits_head(s32.params, hidden[:, fp - 1:], c32, phase="prefill").float().cpu()
    served = torch.stack(steps, 1).float().cpu()
    terms = max(c32.d_ff, c32.d_model, c32.num_heads * c32.head_dim, fp + LLAMA4_F32_NEW)
    tol = f32_tol(terms)
    tdiff, tscale = (served - tf).abs().max().item(), tf.abs().max().item()
    emit(phase="moe_vlm", arch=LLAMA4, step="float32 decode vs teacher-forced", layers=1,
         capacity_factor=c32.capacity_factor, batch=fb, prompt=fp, new_tokens=LLAMA4_F32_NEW,
         served_s=served_s, launches={k: counts[k] for k in ("mpo_linear_fwd_mma",
                                                            "mpo_linear_fwd")},
         teacher_forced_max_abs_diff=tdiff, scale=tscale, summed_terms=terms, tol=tol)
    if not tdiff <= tol * tscale:
        fail(f"{LLAMA4} float32: decode logits {tdiff} from the teacher-forced forward's "
             f"(tol {tol} x {tscale})")
    f32_stacked[f"{LLAMA4} float32 1 layer serve"] = counts[st]
    f32_mma[f"{LLAMA4} float32 1 layer serve"] = counts["mpo_linear_fwd_mma"]
    f32_flash[f"{LLAMA4} float32 1 layer serve"] = counts["flash_decode_attention"]
    del s32, h, hidden, steps
    torch.cuda.empty_cache()

    # (d) phi3.5-moe, bf16, full width, PHI35_LAYERS layers, the weight cache;
    # then a pool under open-loop traffic; then float32 at 2 layers
    pcfg = dataclasses.replace(pcfg_full, num_layers=PHI35_LAYERS)
    rk, total = moe_memory(pcfg, LLM_BATCH, LLM_MAX_LEN, LLM_PROMPT)
    emit(phase="moe_vlm", arch=PHI35, step="memory", layers=PHI35_LAYERS, card_bytes=card_bytes,
         **rk, sum_bytes=total)
    pp = lrng.integers(0, pcfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)
    t0 = sync_clock()
    sess = Session.init(pcfg, seed=SEED)
    init_s = sync_clock() - t0
    handle, per_prefill, per_decode, _ = serve_run(
        sess, f"{PHI35} ({PHI35_LAYERS} layers)", pp, LLM_MAX_LEN,
        ("mpo_linear_fwd_mma", "flash_decode_attention"), new_tokens=LLM_NEW, paged=True,
        weight_cache=True)
    cached = sum(_at(handle.params, p[:-1])["w"].numel() * 2
                 for p in SQ.find_mpo_layers(sess.params) if "w" in _at(handle.params, p[:-1]))
    peak = torch.cuda.max_memory_allocated()
    emit(phase="moe_vlm", arch=PHI35, step="weight cache", layers=PHI35_LAYERS, init_s=init_s,
         cache_weights_s=handle.init_seconds, cached_w_bytes=cached, peak_mem_bytes=peak,
         card_bytes=card_bytes,
         flash_per_decode_step=per_decode["flash_decode_attention"] / (LLM_NEW - 1))
    if cached != rk["cached_w_bf16_bytes"] or peak >= card_bytes:
        fail(f"{PHI35}: cached W {cached} B (reckoned {rk['cached_w_bf16_bytes']}), peak "
             f"{peak} B on a card of {card_bytes}")
    if per_decode["flash_decode_attention"] != PHI35_LAYERS * (LLM_NEW - 1):
        fail(f"{PHI35} weight cache: {per_decode['flash_decode_attention']} flash launches in "
             "decode; once a layer a step")
    exact_launches(f"{PHI35} weight cache", {k: per_prefill[k] + per_decode[k] for k in per_decode},
                   sess, LLM_BATCH, LLM_PROMPT, "bfloat16", [(True, LLM_NEW - 1)])
    sess._serve.clear()
    del handle
    torch.cuda.empty_cache()
    # (d') the same model factorized at MOE_FACT_LAYERS layers: every expert
    # matrix through the stacked forward (16 experts, 640 rows an expert in
    # prefill, 32 in decode)
    cut = Session.init(dataclasses.replace(pcfg, num_layers=MOE_FACT_LAYERS), seed=SEED)
    modes, want = serve_plan(cut.engine, cut.params, cut.cfg, LLM_BATCH, LLM_PROMPT, "bfloat16")
    experts = {k: u for k, u in modes.items() if "/experts/" in k}
    if len(experts) != 3 or any(u != {"prefill": "kernel", "decode": "kernel"}
                                for u in experts.values()):
        fail(f"{PHI35}: the expert matrices plan {experts}, not the kernel in prefill and "
             "decode")
    h, per_prefill, per_decode, _ = serve_run(
        cut, f"{PHI35} ({MOE_FACT_LAYERS} layers)", pp, LLM_MAX_LEN,
        ("mpo_linear_fwd_mma", "flash_decode_attention"), new_tokens=LLM_NEW, paged=True,
        weight_cache=False)
    emit(phase="moe_vlm", arch=PHI35, step="factorized plans", layers=MOE_FACT_LAYERS,
         modes=modes, expert_rows={"prefill": moe_rows(pcfg, LLM_PROMPT),
                                   "decode": moe_rows(pcfg, 1)},
         stacked_launches_per_call=len(experts) * MOE_FACT_LAYERS,
         launches_planned={k: {"prefill": v[0], "decode_step": v[1]} for k, v in want.items()})
    exact_launches(f"{PHI35} factorized", {k: per_prefill[k] + per_decode[k] for k in per_decode},
                   cut, LLM_BATCH, LLM_PROMPT, "bfloat16", [(False, LLM_NEW - 1)])
    moe_paths[f"{PHI35} serve weight_cache=False"] = (
        per_prefill[st] + per_decode[st], len(experts) * MOE_FACT_LAYERS * LLM_NEW)
    cut._serve.clear()
    del h, cut
    torch.cuda.empty_cache()
    ptrace = TRF.make_trace(MOE_POOL_REQUESTS, MOE_POOL_RPS, seed=SEED, prompt_len=(64, 512),
                            max_new=(8, 16), vocab_size=MOE_POOL_VOCAB)
    pool, _, _, _ = open_loop(sess, f"{PHI35} bf16 pool: whole, weight cache", ptrace,
                              MOE_POOL_SLOTS, MOE_POOL_MAX_LEN, ("flash_decode_attention",),
                              **pool_kw)
    del pool, sess
    torch.cuda.empty_cache()
    c32 = dataclasses.replace(pcfg_full, dtype="float32", num_layers=LLM_F32_LAYERS)
    s32 = Session.init(c32, seed=SEED)
    fprompts = lrng.integers(0, c32.vocab_size, (fb, fp)).astype(np.int32)
    f_len = -(-(fp + LLM_F32_NEW) // POOL_PAGE) * POOL_PAGE
    zero_counts()
    runs, margin, wall = greedy_runs(f"{PHI35} float32 token parity", s32, fprompts, f_len,
                                     LLM_F32_NEW)
    counts = read_counts()
    exact_launches(f"{PHI35} float32 runs", counts, s32, fb, fp, "float32",
                   [(False, LLM_F32_NEW - 1), (True, LLM_F32_NEW - 1), (True, LLM_F32_NEW - 1)])
    emit(phase="moe_vlm", arch=PHI35, step="float32 parity", layers=LLM_F32_LAYERS, batch=fb,
         prompt=fp, new_tokens=LLM_F32_NEW, runs=sorted(runs), identical=True,
         min_top2_margin=margin, wall_s=wall,
         launches={k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_fwd",
                                          "flash_decode_attention")})
    f32_stacked[f"{PHI35} float32 {LLM_F32_LAYERS} layers (three runs)"] = counts[st]
    f32_mma[f"{PHI35} float32 {LLM_F32_LAYERS} layers (three runs)"] = counts["mpo_linear_fwd_mma"]
    f32_flash[f"{PHI35} float32 {LLM_F32_LAYERS} layers (three runs)"] = counts[
        "flash_decode_attention"]
    del runs
    ftrace = ptrace[:MOE_F32_REQUESTS]
    zero_counts()
    clock = VirtualClock()
    pool = s32.serve_pool(MOE_POOL_SLOTS, MOE_POOL_MAX_LEN, clock=clock, **pool_kw)
    report = TRF.replay(pool, ftrace, clock=clock)
    counts = read_counts()
    pool_gate(f"{PHI35} float32 pool", counts, ("flash_decode_attention",))
    f32_flash[f"{PHI35} float32 pool"] = counts["flash_decode_attention"]
    del pool
    serial = serial_run(s32, ftrace, MOE_POOL_MAX_LEN, **pool_kw)
    parity = tie_rule(f"{PHI35} float32 pool", [r["tokens"] for r in report.records], serial)
    emit(phase="moe_vlm", run=f"{PHI35} float32 pool, virtual clock", parity=parity,
         summary=report.summary, launches=counts)
    del s32, serial
    torch.cuda.empty_cache()

    # (e) llava-next-34b, bf16, full width: 8 x (1024 patches + 512 tokens),
    # cached at the depth its reckoned peak allows and factorized at
    # MOE_FACT_LAYERS layers; float32 at 2 layers, three runs
    vprompt = vcfg.frontend_len + LLM_PROMPT
    for depth in LLAVA_LAYERS:
        rk, total = moe_memory(dataclasses.replace(vcfg, num_layers=depth), LLM_BATCH,
                               LLAVA_MAX_LEN, vprompt)
        emit(phase="moe_vlm", arch=LLAVA, step="memory", layers=depth, card_bytes=card_bytes,
             limit_bytes=MOE_PEAK_LIMIT, **rk, sum_bytes=total)
        if total < MOE_PEAK_LIMIT:
            break
    else:
        fail(f"{LLAVA}: no depth of {LLAVA_LAYERS} fits {MOE_PEAK_LIMIT} B")
    vp = lrng.integers(0, vcfg.vocab_size, (LLM_BATCH, LLM_PROMPT)).astype(np.int32)
    patches = np.random.default_rng(SEED + 4).normal(
        size=(LLM_BATCH, vcfg.frontend_len, vcfg.frontend_dim)).astype(np.float32)
    for wc, layers in ((True, depth), (False, MOE_FACT_LAYERS)):
        vc = dataclasses.replace(vcfg, num_layers=layers)
        t0 = sync_clock()
        sess = Session.init(vc, seed=SEED)
        init_s = sync_clock() - t0
        handle, per_prefill, per_decode, _ = serve_run(
            sess, f"{LLAVA} ({layers} layers)", vp, LLAVA_MAX_LEN,
            ("mpo_linear_fwd_mma", "flash_decode_attention"), new_tokens=LLM_NEW,
            extra={"patches": patches}, paged=True, weight_cache=wc)
        modes = exact_launches(f"{LLAVA} weight_cache={wc}",
                               {k: per_prefill[k] + per_decode[k] for k in per_decode}, sess,
                               LLM_BATCH, vprompt, "bfloat16", [(wc, LLM_NEW - 1)])
        emit(phase="moe_vlm", arch=LLAVA, step="weight cache" if wc else "factorized",
             layers=layers, depth_cut=layers != vcfg.num_layers, init_s=init_s,
             cache_weights_s=handle.init_seconds, peak_mem_bytes=torch.cuda.max_memory_allocated(),
             card_bytes=card_bytes, modes=modes,
             flash_per_decode_step=per_decode["flash_decode_attention"] / (LLM_NEW - 1))
        if per_decode["flash_decode_attention"] != layers * (LLM_NEW - 1):
            fail(f"{LLAVA} weight_cache={wc}: {per_decode['flash_decode_attention']} flash "
                 "launches in decode; once a layer a step")
        sess._serve.clear()
        del handle, sess
        torch.cuda.empty_cache()
    # one prompt: the float32 prefill sends the FFN (7168 <-> 20480) to
    # csrc/mpo_linear.cu (~6 s a launch at its 1152 rows in the kernel's
    # first, CUDA-core design)
    c32 = dataclasses.replace(vcfg, dtype="float32", num_layers=LLM_F32_DEPTH[LLAVA])
    s32 = Session.init(c32, seed=SEED)
    fb = 1
    fprompts = lrng.integers(0, c32.vocab_size, (fb, fp)).astype(np.int32)
    fpatches = patches[:fb]
    f_len = -(-(vcfg.frontend_len + fp + LLM_F32_NEW) // POOL_PAGE) * POOL_PAGE
    zero_counts()
    runs, margin, wall = greedy_runs(f"{LLAVA} float32 token parity", s32, fprompts, f_len,
                                     LLM_F32_NEW, extra={"patches": fpatches})
    counts = read_counts()
    exact_launches(f"{LLAVA} float32 runs", counts, s32, fb, vcfg.frontend_len + fp, "float32",
                   [(False, LLM_F32_NEW - 1), (True, LLM_F32_NEW - 1), (True, LLM_F32_NEW - 1)])
    emit(phase="moe_vlm", arch=LLAVA, step="float32 parity", layers=LLM_F32_DEPTH[LLAVA],
         batch=fb,
         prompt=fp, patches=vcfg.frontend_len, new_tokens=LLM_F32_NEW, runs=sorted(runs),
         identical=True, min_top2_margin=margin, wall_s=wall,
         launches={k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_fwd",
                                          "flash_decode_attention")})
    for k, d in (("mpo_linear_fwd_mma", f32_mma), ("mpo_linear_fwd", cuda_core),
                 ("flash_decode_attention", f32_flash)):
        if counts[k]:
            d[f"{LLAVA} float32 {LLM_F32_DEPTH[LLAVA]} layers (three runs)"] = counts[k]
    del s32, runs
    torch.cuda.empty_cache()
    emit(phase="moe_vlm", s=time.perf_counter() - v_t0)

    # ---- 13. moe_vlm_train: the cores backward over expert stacks; phi3.5 LFA, llava's lifecycle ----
    t_t0 = time.perf_counter()
    bwd_counters = train_counters + ((MK.mpo_linear_bwd_cores, "stacked_launches"),)

    def train_zero():
        for fn, attr in bwd_counters:
            setattr(fn, attr, 0)

    def train_counts():
        return dict(read_counts(), mpo_linear_bwd_cores=MK.mpo_linear_bwd_cores.launches,
                    mpo_linear_bwd_cores_stacked=MK.mpo_linear_bwd_cores.stacked_launches,
                    mpo_linear_bwd_cores_plain=MK.mpo_linear_bwd_cores_plain.calls)

    def train_gate(path, counts, need):
        """Fail unless every kernel of ``need`` launched and no plain version
        (nor, in bf16, the mpo_linear.cu forward) ran; add the bf16 launches to
        the kernels line."""
        other = (sum(counts[k] for k in plains) + counts["mpo_linear_bwd_cores_plain"]
                 + counts["mpo_linear_fwd"])
        if any(counts[k] == 0 for k in need) or other:
            fail(f"{path}: launches {counts}, plain-version or mpo_linear.cu calls {other}")
        for k in ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores", "mpo_linear_bwd_cores_stacked",
                  "flash_decode_attention"):
            if counts[k]:
                path_launches[k] = path_launches.get(k, 0) + counts[k]
                by_path.setdefault(k, {})[path] = counts[k]

    def stacked_bwd_case(arch, name, stack32, m, dtype, reps):
        """The cores backward over a stack of E experts (5-D cores, x (E, m,
        I), dy (E, m, J)) against its plain version: within ``TOL``, two calls
        bit-identical, each call counted once (and as stacked) and run in the
        launch sets ``_bwd_group`` names, each expert bit-equal to its matrix
        run alone through the 4-D call, the central core skipped leaving the
        other cores' bits, an expert whose rows are all zero (capacity
        padding) exactly zero; the plan's shared memory and the stack's
        scratch equal to the CUDA source's.  Kernel, plain and library
        (``torch.autograd.grad`` of ``torch.bmm(x, W)`` with W the experts'
        ``mpo.reconstruct`` stacked, null where it does not fit the card)
        times, the bound over all E."""
        tdt = getattr(torch, dtype)
        cores = [c.to(tdt).contiguous() for c in stack32]
        e = cores[0].shape[0]
        shapes = tuple(tuple(c.shape[1:]) for c in cores)
        i_dim = math.prod(s[1] for s in shapes)
        j_dim = math.prod(s[2] for s in shapes)
        x = torch.randn(e, m, i_dim, generator=gen).to(dev, tdt)
        dy = torch.randn(e, m, j_dim, generator=gen).to(dev, tdt)
        zero = e // 2
        x[zero], dy[zero] = 0, 0
        what = f"mpo_linear_bwd_cores {arch} {name} ({e} experts) M={m} {dtype}"
        before = (MK.mpo_linear_bwd_cores.launches, MK.mpo_linear_bwd_cores.stacked_launches)
        got = MK.mpo_linear_bwd_cores(cores, x, dy)
        sets, ws_bytes = MK.mpo_linear_bwd_cores.launch_sets, MK.mpo_linear_bwd_cores.workspace_bytes
        again = MK.mpo_linear_bwd_cores(cores, x, dy)
        central = len(cores) // 2
        some = MK.mpo_linear_bwd_cores(cores, x, dy, [k != central for k in range(len(cores))])
        torch.cuda.synchronize()
        plan = MK._bwd_plan(shapes, dtype, sms)
        group = MK._bwd_group(plan.workspace, e)
        if (MK.mpo_linear_bwd_cores.launches, MK.mpo_linear_bwd_cores.stacked_launches) != (
                before[0] + 3, before[1] + 3):
            fail(f"{what}: not one counted (stacked) call a call")
        if (sets, ws_bytes) != (-(-e // group), group * plan.workspace):
            fail(f"{what}: {sets} launch sets and {ws_bytes} B of scratch, the plan's "
                 f"{-(-e // group)} and {group * plan.workspace}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"{what}: two calls differ")
        if some[central] is not None or not all(
                torch.equal(a, b) for k, (a, b) in enumerate(zip(some, got)) if k != central):
            fail(f"{what}: the call without core {central} differs from the full call")
        for k in range(e):
            alone = MK.mpo_linear_bwd_cores([c[k] for c in cores], x[k], dy[k])
            if not all(torch.equal(g[k], a) for g, a in zip(got, alone)):
                fail(f"{what}: expert {k} differs from its matrix run alone")
        if any(bool(g[zero].any()) for g in got):
            fail(f"{what}: the all-zero expert {zero} has a nonzero gradient")
        del again, some, alone
        ref = MK.mpo_linear_bwd_cores_plain(cores, x, dy)
        err = max(check("mpo_linear_bwd_cores", g, r, dtype, f"{what} core {k}")
                  for k, (g, r) in enumerate(zip(got, ref)))
        rel = max(((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                  for g, r in zip(got, ref))
        del got, ref
        dims = (ctypes.c_int * (4 * len(cores)))(*[d for sh in shapes for d in sh])
        ws_c = 4 * bwd_lib.mpo_linear_bwd_workspace(dims, len(cores), plan.split,
                                                    plan.blocks // plan.cluster, group)
        smem_c = bwd_lib.mpo_linear_bwd_smem(dims, len(cores), plan.split, plan.tr, plan.tc,
                                             MK.DTYPES[tdt])
        if (smem_c, ws_c) != (plan.smem, group * plan.workspace):
            fail(f"{what}: the plan's shared memory / scratch {plan.smem} / "
                 f"{group * plan.workspace} differ from the CUDA source's {smem_c} / {ws_c}")

        def library():
            cs = [c.detach().requires_grad_() for c in cores]
            w = torch.stack([mpo.reconstruct([c[k] for c in cs]) for k in range(e)])
            return torch.autograd.grad(torch.bmm(x, w), cs, dy)

        torch.cuda.empty_cache()
        try:
            library_ms = timed(library, reps)
        except torch.cuda.OutOfMemoryError:
            library_ms = None
        torch.cuda.empty_cache()
        ds = shapes[plan.split][0]
        nbytes = x.element_size() * (x.numel() + dy.numel() + 2 * sum(c.numel() for c in cores))
        ops = e * (2 * m * i_dim * j_dim + 4 * ds * i_dim * j_dim)
        rec = dict(kernel="mpo_linear_bwd_cores", matrix=f"{arch} {name}", experts=e,
                   shapes=[list(c.shape) for c in cores], M=m, dtype=dtype, split=plan.split,
                   tile=[plan.tr, plan.tc], tiles=plan.tiles, blocks=plan.blocks,
                   cluster=plan.cluster, smem_bytes=plan.smem, group=group, launch_sets=sets,
                   launches_per_call=MK.BWD_KERNELS * sets, workspace_bytes=group * plan.workspace,
                   workspace_per_expert=plan.workspace,
                   dense_dw_f32_bytes_all_experts=4 * e * i_dim * j_dim, zero_expert=zero,
                   max_abs_err=err, max_rel_err=rel, tol=tol, deterministic=True,
                   kernel_ms=timed(lambda: MK.mpo_linear_bwd_cores(cores, x, dy), reps),
                   plain_ms=timed(lambda: MK.mpo_linear_bwd_cores_plain(cores, x, dy), reps),
                   library_ms=library_ms, library_fits=library_ms is not None,
                   bound_ms=1e3 * max(nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S[dtype]),
                   bound_by="bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_OPS_S[dtype]
                   else "operations")
        emit(phase="moe_vlm_train", **rec)
        torch.cuda.empty_cache()
        return rec

    # (a) the stacked cores backward at the full-width expert shapes, at a
    # training batch's capacity rows (MOE_TRAIN_BATCH x MOE_TRAIN_SEQ): phi3.5's
    # w_up and w_down (16 experts, 320 rows an expert), llama4's w_up (128
    # experts, 20 rows an expert), both dtypes
    train_rows = lambda cfg: moe_rows(cfg, MOE_TRAIN_SEQ, MOE_TRAIN_BATCH)
    for arch, cfg, names, reps in ((PHI35, pcfg_full, ("w_up", "w_down"), STACK_REPS),
                                   (LLAMA4, l4cfg, ("w_up",), 1)):
        for name in names:
            stack = expert_cores(cfg, name)
            for dtype in ("bfloat16", "float32"):
                results[("stacked_bwd", arch, name, dtype)] = stacked_bwd_case(
                    arch, name, stack, train_rows(cfg), dtype, reps)
            del stack
            torch.cuda.empty_cache()

    # (b) the smoke models in float32, every MPO matmul in the kernel mode:
    # one train step's gradients of every leaf and a 3-step loss trajectory,
    # card against CPU
    f32_stacked_bwd = {}

    def smoke_grads_and_losses(arch, device):
        ss = Session.init(kernel_mode(configs.smoke_config(arch)), seed=SEED, device=device)
        train_zero()
        seen = []
        rec_opt = OPT.Optimizer(init=lambda p: OPT.OptState(0, None),
                                update=lambda g, st, p: seen.append(g) or st)
        step = TS.make_train_step(ss.model, rec_opt, ss._default_loss_fn())
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in ss._default_batch_fn(16, 4, SEED)(0).items()}
        step(TS.TrainState(ss.params, rec_opt.init(ss.params)), batch)
        grads = [g.detach().cpu() for g in lightweight.leaves(seen[0])]
        hist = ss.finetune(steps=3, seq_len=16, batch_size=4, log_every=1)["history"]
        if device == "cuda":
            counts = train_counts()
            got = gate_routes(f"the float32 smoke {arch} train steps on the card", counts,
                              ss.params, train=True)
            moe = ss.cfg.family == "moe"
            if (not counts["mpo_linear_bwd_cores"] or counts["mpo_linear_bwd_cores_plain"]
                    or bool(counts["mpo_linear_bwd_cores_stacked"]) != moe):
                fail(f"the float32 smoke {arch} train steps on the card: {counts}")
            where = f"smoke {arch} train (4 steps)"
            cuda_core[where] = got["mpo_linear_fwd"]
            f32_mma[where] = got["mpo_linear_fwd_mma"]
            f32_bwd[where] = counts["mpo_linear_bwd_cores"]
            for k, d in (("mpo_linear_fwd_mma_stacked", f32_stacked),
                         ("mpo_linear_fwd_stacked", f32_moe_core),
                         ("mpo_linear_bwd_cores_stacked", f32_stacked_bwd)):
                if counts[k]:
                    d[where] = counts[k]
        return grads, [h["loss"] for h in hist], [h["aux"] for h in hist]

    for arch in MOE_ARCHS:
        card, cpu = smoke_grads_and_losses(arch, "cuda"), smoke_grads_and_losses(arch, "cpu")
        gdiff = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                    for a, b in zip(card[0], cpu[0]))
        ldiff = max(abs(a - b) / abs(b) for a, b in zip(card[1], cpu[1]))
        emit(phase="moe_vlm_train", smoke=arch, mode="kernel", dtype="float32",
             leaves=len(card[0]), card_vs_cpu_grad_rel_diff=gdiff,
             card_vs_cpu_loss_rel_diff=ldiff, losses_card=card[1], losses_cpu=cpu[1],
             aux_card=card[2], aux_cpu=cpu[2], tol=TRAIN_TOL)
        if not gdiff <= TRAIN_TOL or not ldiff <= TRAIN_TOL:
            fail(f"smoke {arch} train step on the card differs from the CPU: grads {gdiff}, "
                 f"losses {card[1]} vs {cpu[1]}")

    # (c) full-width phi3.5-moe, bf16, LFA at PHI35_TRAIN_LAYERS layers
    pt_cfg = dataclasses.replace(pcfg_full, num_layers=PHI35_TRAIN_LAYERS)
    ft = dict(mode="lfa", seq_len=MOE_TRAIN_SEQ, batch_size=MOE_TRAIN_BATCH, log_every=1)
    sess = Session.init(pt_cfg, seed=SEED)
    rows = {}
    for path, cd in SQ.find_mpo_layers(sess.params).items():
        cores = cores_to_list(cd)
        shapes = tuple(tuple(c.shape[-4:]) for c in cores)
        m = (train_rows(pt_cfg) if "experts" in path
             else MOE_TRAIN_BATCH * MOE_TRAIN_SEQ)
        rows["/".join(path[:-1])] = (sess.engine.plan(shapes, m, "train", "bfloat16",
                                                      "cuda").mode, m, shapes)
    experts = [k for k, (mode, _, _) in rows.items() if "/experts/" in k and mode == "kernel"]
    if len(experts) != 3:
        fail(f"{PHI35}: the expert matrices plan {rows} in training, not the kernel")
    # each expert matrix: the stacked forward, its recomputation (remat) and
    # dL/dx over W^T's cores, and one stacked cores-backward call, a layer a step
    fwd_per_step = (3 if pt_cfg.remat else 2) * len(experts) * PHI35_TRAIN_LAYERS
    bwd_per_step = len(experts) * PHI35_TRAIN_LAYERS
    central = {k: v.clone() for k, v in sess.model.state_dict().items() if k.endswith(".central")}
    sess.finetune(steps=1, seed=SEED + 1, **ft)            # warm-up, not counted
    train_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_clock()
    rep = sess.finetune(steps=MOE_TRAIN_STEPS, seed=SEED, **ft)
    pt_s = sync_clock() - t0
    counts = train_counts()
    losses = [h["loss"] for h in rep["history"]]
    auxes = [h["aux"] for h in rep["history"]]
    unchanged = all(torch.equal(v, sess.model.state_dict()[k]) for k, v in central.items())
    e = pt_cfg.num_experts
    scratch = {}
    for k in experts:
        shapes = rows[k][2]
        plan = MK._bwd_plan(shapes, "bfloat16", sms)
        group = MK._bwd_group(plan.workspace, e)
        scratch[k] = {"group": group, "launch_sets": -(-e // group),
                      "workspace_bytes": group * plan.workspace,
                      "dense_dw_f32_bytes_all_experts": 4 * e * math.prod(s[1] for s in shapes)
                      * math.prod(s[2] for s in shapes)}
    emit(phase="moe_vlm_train", step="finetune lfa", arch=PHI35, dtype=pt_cfg.dtype,
         layers=PHI35_TRAIN_LAYERS, remat=pt_cfg.remat, batch=MOE_TRAIN_BATCH,
         seq_len=MOE_TRAIN_SEQ, steps=MOE_TRAIN_STEPS, expert_rows=train_rows(pt_cfg),
         ms_per_step=1e3 * pt_s / MOE_TRAIN_STEPS,
         tokens_per_s=MOE_TRAIN_BATCH * MOE_TRAIN_SEQ * MOE_TRAIN_STEPS / pt_s,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), losses=losses, aux=auxes,
         trainable=rep["trainable"], total=rep["total"], reduction=rep["reduction"],
         train_modes={k: v[:2] for k, v in rows.items()}, launches=counts,
         launches_per_step={k: v / MOE_TRAIN_STEPS for k, v in counts.items()},
         planned_per_step={"mpo_linear_fwd_mma_stacked": fwd_per_step,
                           "mpo_linear_bwd_cores_stacked": bwd_per_step},
         central_cores=len(central), central_unchanged=unchanged, stacked_bwd_scratch=scratch)
    if len(losses) != MOE_TRAIN_STEPS or not all(math.isfinite(v) for v in losses + auxes) \
            or not all(a > 0 for a in auxes):
        fail(f"{PHI35} fine-tuning: losses {losses}, aux {auxes}")
    if not central or not unchanged:
        fail(f"{PHI35} fine-tuning: a central core changed under LFA")
    if (rep["trainable"], rep["total"]) != PHI35_LFA_COUNTS:
        fail(f"{PHI35} fine-tuning: {rep['trainable']} of {rep['total']} trainable, expected "
             f"{PHI35_LFA_COUNTS}")
    if (counts["mpo_linear_bwd_cores_stacked"], counts["mpo_linear_fwd_mma_stacked"]) != (
            bwd_per_step * MOE_TRAIN_STEPS, fwd_per_step * MOE_TRAIN_STEPS):
        fail(f"{PHI35} fine-tuning: stacked launches {counts}, planned {bwd_per_step} "
             f"backward and {fwd_per_step} forward a step")
    train_gate(f"{PHI35} finetune lfa ({PHI35_TRAIN_LAYERS} layers)", counts,
               ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores", "mpo_linear_bwd_cores_stacked"))
    del sess, central
    torch.cuda.empty_cache()

    # a run preempted at step 4 and resumed, against one run straight through
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_moe_"))
    try:
        a = Session.init(pt_cfg, seed=SEED)
        train_zero()
        a.finetune(steps=MOE_TRAIN_STEPS, ckpt_dir=str(tmp / "a"), seed=SEED, **ft)
        train_gate(f"{PHI35} finetune straight through", train_counts(),
                   ("mpo_linear_bwd_cores_stacked",))
        b = Session.init(pt_cfg, seed=SEED)
        with FLT.fault_scope(FLT.FaultPlan(preempt_finetune_step=4)):
            expect_raise(FLT.Preemption, lambda: b.finetune(
                steps=MOE_TRAIN_STEPS, ckpt_dir=str(tmp / "b"), seed=SEED, **ft),
                f"{PHI35} preempted finetune")
        drained = CKM.CheckpointManager(str(tmp / "b")).latest_step()
        train_zero()
        t0 = sync_clock()
        b.finetune(steps=MOE_TRAIN_STEPS, ckpt_dir=str(tmp / "b"), seed=SEED, **ft)
        resume_s = sync_clock() - t0
        counts = train_counts()
        with np.load(tmp / "a" / f"step_{MOE_TRAIN_STEPS}" / "arrays.npz") as za, \
                np.load(tmp / "b" / f"step_{MOE_TRAIN_STEPS}" / "arrays.npz") as zb:
            keys = sorted(za.files)
            differ = [k for k in keys if not np.array_equal(za[k], zb[k])]
            same_keys = keys == sorted(zb.files)
            expert_arrays = sum(za[k].ndim == 6 for k in keys)
        params_equal = same(params_of(a), params_of(b))
        emit(phase="moe_vlm_train", step="finetune resume", arch=PHI35, preempted_at=4,
             latest_step_after_preemption=drained, resumed_s=resume_s, launches_resumed=counts,
             arrays=len(keys), expert_arrays_6d=expert_arrays, arrays_differing=differ,
             params_bit_identical=params_equal)
        if drained != 4:
            fail(f"{PHI35} preempted finetune: latest step {drained}, expected 4")
        if not same_keys or differ or not params_equal or not expert_arrays:
            fail(f"{PHI35} finetune resume: arrays differing {differ}, same keys {same_keys}, "
                 f"params bit-identical {params_equal}, 6-D expert arrays {expert_arrays}")
        if counts["mpo_linear_bwd_cores_stacked"] != bwd_per_step * (MOE_TRAIN_STEPS - 4):
            fail(f"{PHI35} finetune resume: {counts['mpo_linear_bwd_cores_stacked']} stacked "
                 "cores-backward calls")
        train_gate(f"{PHI35} finetune resumed", counts, ("mpo_linear_bwd_cores_stacked",))
        del a, b
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (d) full-width llava-next-34b, bf16, LLAVA_TRAIN_LAYERS layers: from_dense
    # of an exact tree made on the card -> LFA with 1024 patches + text ->
    # one squeeze iteration -> served both ways under (e) of phase 12's gates
    lt_cfg = dataclasses.replace(vcfg, num_layers=LLAVA_TRAIN_LAYERS)
    src = Session.init(lt_cfg, seed=SEED)
    vdense = exact_dense(src.params)
    del src
    t0 = sync_clock()
    vs = Session.from_dense(vdense, lt_cfg)
    conv_s = sync_clock() - t0
    del vdense
    torch.cuda.empty_cache()
    rep = vs.report()
    emit(phase="moe_vlm_train", step="from_dense exact", arch=LLAVA, layers=LLAVA_TRAIN_LAYERS,
         matrices=rep["stages"][-1]["matrices"], from_dense_s=conv_s,
         conversion_rel_err=vs.conversion_report,
         conversion_max_rel_err=rep["conversion_max_rel_err"], tol=EXACT_TOL)
    if not rep["conversion_max_rel_err"] <= EXACT_TOL:
        fail(f"{LLAVA} from_dense of an exact tree: error {rep['conversion_max_rel_err']}")
    vft = dict(mode="lfa", seq_len=vcfg.frontend_len + LLAVA_TRAIN_TEXT,
               batch_size=LLAVA_TRAIN_BATCH, log_every=1)
    central = {k: v.clone() for k, v in vs.model.state_dict().items() if k.endswith(".central")}
    projector = vs.model.state_dict()["projector.w"].clone()
    train_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_clock()
    rep = vs.finetune(steps=LIFE_STEPS, seed=SEED, **vft)
    vt_s = sync_clock() - t0
    counts = train_counts()
    losses = [h["loss"] for h in rep["history"]]
    unchanged = all(torch.equal(v, vs.model.state_dict()[k]) for k, v in central.items())
    moved = not torch.equal(projector, vs.model.state_dict()["projector.w"])
    emit(phase="moe_vlm_train", step="finetune lfa", arch=LLAVA, layers=LLAVA_TRAIN_LAYERS,
         dtype=lt_cfg.dtype, batch=LLAVA_TRAIN_BATCH, patches=vcfg.frontend_len,
         text=LLAVA_TRAIN_TEXT, steps=LIFE_STEPS, ms_per_step=1e3 * vt_s / LIFE_STEPS,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         trainable=rep["trainable"], total=rep["total"], launches=counts,
         central_unchanged=unchanged, projector_trained=moved)
    if len(losses) != LIFE_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{LLAVA} fine-tuning: losses {losses}")
    if not central or not unchanged or not moved:
        fail(f"{LLAVA} fine-tuning: central cores unchanged {unchanged}, projector trained "
             f"{moved}")
    if (rep["trainable"], rep["total"]) != LLAVA_LFA_COUNTS:
        fail(f"{LLAVA} fine-tuning: {rep['trainable']} of {rep['total']} trainable, expected "
             f"{LLAVA_LFA_COUNTS}")
    if counts["mpo_linear_bwd_cores_stacked"] or counts["mpo_linear_fwd_mma_stacked"]:
        fail(f"{LLAVA} fine-tuning: stacked launches {counts} (it has no expert stack)")
    train_gate(f"{LLAVA} finetune lfa ({LLAVA_TRAIN_LAYERS} layers)", counts,
               ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))
    # one squeeze iteration (delta = 1.0 accepts it), its re-tune at the same batch
    pre = lightweight.tree_map(lambda t: t.detach().clone(), vs.params)
    rho0 = SQ.model_compression_ratio(vs.params)
    train_zero()
    t0 = sync_clock()
    evs = vs.squeeze(step=1, max_iters=1, finetune_steps=2, seq_len=vft["seq_len"],
                     batch_size=LLAVA_TRAIN_BATCH, delta=1.0)
    sq_s = sync_clock() - t0
    counts = train_counts()
    rho1 = SQ.model_compression_ratio(vs.params)
    for ev in evs:
        rc = check_event(ev, pre)
        emit(phase="moe_vlm_train", step="squeeze iteration", arch=LLAVA,
             layer="/".join(ev.layer[:-1]), bond=ev.bond, new_dim=ev.new_dim,
             predicted_error=ev.predicted_error, metric=ev.metric, seconds=ev.seconds, **rc)
    del pre
    emit(phase="moe_vlm_train", step="squeeze", arch=LLAVA, s=sq_s, events=len(evs),
         rho_before=rho0, rho_after=rho1, launches=counts)
    if len(evs) != 1 or not rho1 < rho0:
        fail(f"{LLAVA} squeeze: {len(evs)} events, rho {rho0} -> {rho1}")
    train_gate(f"{LLAVA} squeeze (re-tune and evaluations)", counts,
               ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"))
    for wc in (True, False):
        handle, per_prefill, per_decode, _ = serve_run(
            vs, f"{LLAVA} lifecycle ({LLAVA_TRAIN_LAYERS} layers)", vp, LLAVA_MAX_LEN,
            ("mpo_linear_fwd_mma", "flash_decode_attention"), new_tokens=LLM_NEW,
            extra={"patches": patches}, paged=True, weight_cache=wc)
        exact_launches(f"{LLAVA} lifecycle weight_cache={wc}",
                       {k: per_prefill[k] + per_decode[k] for k in per_decode}, vs, LLM_BATCH,
                       vprompt, "bfloat16", [(wc, LLM_NEW - 1)])
        if per_decode["flash_decode_attention"] != LLAVA_TRAIN_LAYERS * (LLM_NEW - 1):
            fail(f"{LLAVA} lifecycle weight_cache={wc}: {per_decode['flash_decode_attention']} "
                 "flash launches in decode; once a layer a step")
        del handle
    vs._serve.clear()
    del vs
    torch.cuda.empty_cache()
    emit(phase="moe_vlm_train", s=time.perf_counter() - t_t0)

    # ---- 14. hybrid: zamba2-7b's Mamba2 segments and shared attention blocks ----
    from repro_torch.models import zamba as ZB
    z_t0 = time.perf_counter()
    zcfg = configs.get_config(HYBRID)
    hyb = {}                 # kernel -> {hybrid path: launches}, for the kernels line

    def hyb_gate(path, counts, need):
        """``ssm_gate``'s rule (each kernel of ``need`` launched, no plain
        version, no mpo_linear.cu forward), the launches kept apart too."""
        ssm_gate(path, counts, need)
        for k in ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores", "ssd_scan", "ssd_scan_bwd"):
            if counts[k]:
                hyb.setdefault(k, {})[path] = counts[k]

    def hyb_counts():
        """``ssm_counts`` with the stacked forward's counts (``llm_gate``
        reads them)."""
        return dict(read_counts(), **ssm_counts())

    def hyb_train_bwd(sess, rows):
        """{matrix: cores-backward calls a step} of the layer matrices the
        bf16 train plan sends to the kernel: a Mamba2 layer's once, a shared
        block's once a segment that takes it."""
        cfg, out = sess.cfg, {}
        for path, cd in SQ.find_mpo_layers(sess.params).items():
            shapes = tuple(tuple(c.shape[-4:]) for c in cores_to_list(cd))
            if path[0] == "embed":
                continue                  # the tied head and the lookup: not trained as x @ W
            if sess.engine.plan(shapes, rows, "train", "bfloat16", "cuda").mode == "kernel":
                out["/".join(path[:-1])] = (cfg.num_layers // cfg.attn_every
                                            if path[0] == "shared_attn" else cfg.num_layers)
        return out

    # (a) the kernels at zamba2-7b's shapes against their plain versions: one
    # layer of a HYB_LIFE_LAYERS-layer model drawn on the card (also (e)'s
    # source)
    zsrc = Session.init(dataclasses.replace(zcfg, num_layers=HYB_LIFE_LAYERS), seed=SEED,
                        init_device="cuda")
    zm = {name: [c[0] for c in cores_to_list(_at(zsrc.params, path)["cores"])]
          for name, path in (("in_proj", ("mamba", "in_proj")),
                             ("out_proj", ("mamba", "out_proj")),
                             ("w_up", ("shared_attn", "mlp", "w_up")),
                             ("w_down", ("shared_attn", "mlp", "w_down")),
                             ("wq", ("shared_attn", "attn", "wq")))}
    # (in_proj's forward takes ~0.3 s a call at 8 x 512 rows in bf16: timed
    # at 3 calls there)
    zrows = HYB_BATCH * HYB_PROMPT
    for dtype in ("bfloat16", "float32"):
        for name, ms in (("in_proj", (8, zrows)), ("out_proj", (zrows,)), ("w_up", (zrows,))):
            i_dim = math.prod(c.shape[1] for c in zm[name])
            for m in ms:
                results[("mpo", HYBRID, name, m, dtype)] = fwd_case(
                    f"{HYBRID} {name}", zm[name], m, dtype, phase="hybrid",
                    reps=3 if m == zrows else 10,
                    tol=f32_tol(i_dim) if dtype == "float32" else None)
    # the float32 attention matrices' route (the bf16 plan refuses them)
    results[("mpo", HYBRID, "wq", 128, "float32")] = fwd_case(
        f"{HYBRID} wq", zm["wq"], 128, "float32", phase="hybrid", reps=3,
        tol=f32_tol(zcfg.d_model))
    ztok = HYB_TRAIN_BATCH * HYB_TRAIN_SEQ
    for name in ("out_proj", "w_up", "w_down"):
        for dtype in ("bfloat16", "float32") if name == "out_proj" else ("bfloat16",):
            results[("bwd", HYBRID, name, dtype)] = bwd_case(
                f"{HYBRID} {name}", zm[name], ztok, dtype, phase="hybrid", dw_gate=False)
    for dtype in ("bfloat16", "float32"):
        results[("ssd", HYBRID, dtype)] = ssd_case(HYB_BATCH, HYB_PROMPT, dtype, geom=zcfg,
                                                   phase="hybrid")
        results[("ssd_bwd", HYBRID, dtype)] = ssd_bwd_case(
            HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, dtype, True, True, geom=zcfg, phase="hybrid")
    del zm
    torch.cuda.empty_cache()

    # (b) the smoke model (6 layers: shared block 0 serves segments 0 and 2)
    # in float32, every matmul in the kernel mode, on the card against the
    # CPU: prefill and decode logits (the card fed the CPU's tokens), one
    # train step's gradients of every leaf and a 3-step loss trajectory
    zsmoke = kernel_mode(configs.smoke_config(HYBRID, num_layers=6))
    zsp = np.random.default_rng(SEED + 6).integers(0, zsmoke.vocab_size, (4, 24))

    def hyb_smoke(device, feed=None):
        ss = Session.init(zsmoke, seed=SEED, device=device)
        ssm_zero()
        h = ss.serve(4, 40, weight_cache=False)
        steps = [h.prefill({"tokens": zsp})[:, -1].float().cpu()]
        toks = []
        for k in range(4):
            tok = (torch.argmax(steps[-1], -1)[:, None].to(torch.int32) if feed is None
                   else feed[:, k:k + 1])
            toks.append(tok)
            steps.append(h.decode(tok)[1][:, -1].float().cpu())
        serve_counts = ssm_counts()
        ssm_zero()
        seen = []
        rec_opt = OPT.Optimizer(init=lambda p: OPT.OptState(0, None),
                                update=lambda g, st, p: seen.append(g) or st)
        step = TS.make_train_step(ss.model, rec_opt, ss._default_loss_fn())
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in ss._default_batch_fn(16, 4, SEED)(0).items()}
        step(TS.TrainState(ss.params, rec_opt.init(ss.params)), batch)
        grads = [g.detach().cpu() for g in lightweight.leaves(seen[0])]
        hist = ss.finetune(steps=3, seq_len=16, batch_size=4, log_every=1)["history"]
        if device == "cuda":
            gate_routes(f"the float32 smoke {HYBRID} serving on the card", serve_counts,
                        ss.params, train=False)
            counts = ssm_counts()
            got = gate_routes(f"the float32 smoke {HYBRID} train steps on the card", counts,
                              ss.params, train=True, tied_head=True)
            if (serve_counts["ssd_scan"] != ss.cfg.num_layers or not counts["ssd_scan_bwd"]
                    or not counts["mpo_linear_bwd_cores"]
                    or any(counts[k] for k in ssm_plains)):
                fail(f"the float32 smoke {HYBRID} on the card: serving {serve_counts}, "
                     f"train steps {counts}")
            where = f"smoke {HYBRID} train (4 steps)"
            for k, d in (("mpo_linear_fwd", cuda_core), ("mpo_linear_fwd_mma", f32_mma)):
                if got[k]:
                    d[where] = got[k]
            f32_bwd[where] = counts["mpo_linear_bwd_cores"]
            f32_ssd[where] = counts["ssd_scan"] + serve_counts["ssd_scan"]
            f32_ssd_bwd[where] = counts["ssd_scan_bwd"]
        return torch.stack(steps, 1), torch.cat(toks, 1), grads, [h["loss"] for h in hist]

    cpu = hyb_smoke("cpu")
    card = hyb_smoke("cuda", feed=cpu[1].to(dev))
    ldiff = (card[0] - cpu[0]).abs().max().item()
    lscale = cpu[0].abs().max().item()
    gdiff = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(card[2], cpu[2]))
    hdiff = max(abs(a - b) / abs(b) for a, b in zip(card[3], cpu[3]))
    emit(phase="hybrid", smoke=HYBRID, layers=zsmoke.num_layers, mode="kernel", dtype="float32",
         card_vs_cpu_logits_diff=ldiff, scale=lscale, tol=SMOKE_TOL, leaves=len(card[2]),
         card_vs_cpu_grad_rel_diff=gdiff, card_vs_cpu_loss_rel_diff=hdiff,
         losses_card=card[3], losses_cpu=cpu[3], train_tol=TRAIN_TOL)
    if ldiff > SMOKE_TOL * lscale or not gdiff <= TRAIN_TOL or not hdiff <= TRAIN_TOL:
        fail(f"smoke {HYBRID} on the card differs from the CPU: logits {ldiff} (scale "
             f"{lscale}), grads {gdiff}, losses {card[3]} vs {cpu[3]}")
    del card, cpu

    # (c) full width, bf16: all 81 layers with the weight cache, then
    # factorized at HYB_FACT_LAYERS; 81 SSD-scan launches a prefill
    zprompts = np.random.default_rng(SEED + 5).integers(
        0, zcfg.vocab_size, (HYB_BATCH, HYB_PROMPT)).astype(np.int32)

    def hyb_serve(sess, what, wc):
        handle, per_prefill, per_decode, logits = serve_run(
            sess, what, zprompts, HYB_MAX_LEN, ("mpo_linear_fwd_mma", "ssd_scan"),
            new_tokens=HYB_NEW, weight_cache=wc)
        layers = sess.cfg.num_layers
        if per_prefill["ssd_scan"] != layers or per_decode["ssd_scan"]:
            fail(f"{what} weight_cache={wc}: {per_prefill['ssd_scan']} SSD-scan launches a "
                 f"prefill (expected {layers}), {per_decode['ssd_scan']} in decode")
        _, want = serve_plan(sess.engine, sess.params, sess.cfg, HYB_BATCH, HYB_PROMPT,
                             "bfloat16", weight_cache=wc)
        llm_gate(f"{what} weight_cache={wc} prefill", per_prefill,
                 {k: v[0] for k, v in want.items()})
        llm_gate(f"{what} weight_cache={wc} decode", per_decode,
                 {k: v[1] * (HYB_NEW - 1) for k, v in want.items()})
        counts = {k: per_prefill[k] + per_decode[k] for k in per_prefill}
        for k in ("mpo_linear_fwd_mma", "ssd_scan"):
            if counts[k]:
                hyb.setdefault(k, {})[f"{what} serve weight_cache={wc}"] = counts[k]
        cached = sum(_at(handle.params, p[:-1])["w"].numel() * 2
                     for p in SQ.find_mpo_layers(sess.params) if "w" in _at(handle.params, p[:-1]))
        return handle, logits, cached

    del zsrc
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_clock()
    zs = Session.init(zcfg, seed=SEED, init_device="cuda")
    z_init_s = sync_clock() - t0
    z_init_peak = torch.cuda.max_memory_allocated()
    master = sum(t.numel() * t.element_size() for t in lightweight.leaves(zs.params))
    handle, _, cached = hyb_serve(zs, HYBRID, True)
    emit(phase="hybrid", arch=HYBRID, step="weight cache", layers=zcfg.num_layers,
         init_s=z_init_s, init_peak_bytes=z_init_peak, master_f32_bytes=master,
         cache_weights_s=handle.init_seconds, cached_w_bytes=cached,
         ssm_state_bytes=handle.cache["ssm"].numel() * 4,
         kv_cache_bytes=2 * handle.cache["kv"]["k"].numel() * 2,
         decode_ms_per_step=decode_step_ms[(HYBRID, True)])
    zs._serve.clear()
    del handle, zs
    torch.cuda.empty_cache()
    zf = Session.init(dataclasses.replace(zcfg, num_layers=HYB_FACT_LAYERS), seed=SEED,
                      init_device="cuda")
    fmodes, _ = serve_plan(zf.engine, zf.params, zf.cfg, HYB_BATCH, HYB_PROMPT, "bfloat16")
    handle, _, _ = hyb_serve(zf, f"{HYBRID} ({HYB_FACT_LAYERS} layers)", False)
    emit(phase="hybrid", arch=HYBRID, step="factorized plans", layers=HYB_FACT_LAYERS,
         depth_cut=True, modes=fmodes)
    zf._serve.clear()
    del handle, zf
    torch.cuda.empty_cache()

    # float32 at HYB_F32_LAYERS layers from one prompt: the cached and the
    # factorized runs' tokens identical, every decode step's logits within
    # f32_tol of the teacher-forced forward's on the same tokens
    z32cfg = dataclasses.replace(zcfg, dtype="float32", num_layers=HYB_F32_LAYERS)
    z32 = Session.init(z32cfg, seed=SEED, init_device="cuda")
    fprompt = np.random.default_rng(SEED + 7).integers(
        0, zcfg.vocab_size, (1, HYB_F32_PROMPT)).astype(np.int32)
    zruns, zwall = {}, {}
    ssm_zero()
    for name, wc in (("cached", True), ("factorized", False)):
        t0 = sync_clock()
        h = z32.serve(1, HYB_F32_PROMPT + HYB_NEW, weight_cache=wc)
        lg = h.prefill({"tokens": fprompt})
        steps = [lg[:, -1]]
        tok = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
        toks = [tok]
        for _ in range(HYB_NEW - 1):
            tok, lg = h.decode(tok)
            toks.append(tok)
            steps.append(lg[:, -1])
        zruns[name] = (torch.cat(toks, 1).cpu(), torch.stack(steps, 1).float().cpu())
        zwall[name] = sync_clock() - t0
        z32._serve.clear()
        del h
    counts = hyb_counts()
    _, want = serve_plan(z32.engine, z32.params, z32cfg, 1, HYB_F32_PROMPT, "float32")
    want_all = {k: v[0] + v[1] * (HYB_NEW - 1) for k, v in want.items()}
    _, want_c = serve_plan(z32.engine, z32.params, z32cfg, 1, HYB_F32_PROMPT, "float32",
                           weight_cache=True)
    for k, v in want_c.items():
        want_all[k] = want_all.get(k, 0) + v[0] + v[1] * (HYB_NEW - 1)
    llm_gate(f"{HYBRID} float32 runs", counts, want_all)
    seq = torch.cat([torch.as_tensor(fprompt), zruns["cached"][0][:, :-1]], 1).to(dev)
    tree = z32.model.cache_weights(z32.params)
    with torch.no_grad():
        hidden = ZB.forward_hidden(tree, {"tokens": seq}, z32cfg, phase="prefill")
        tf = ZB.logits_head(tree, hidden[:, HYB_F32_PROMPT - 1:], z32cfg,
                            phase="prefill").float().cpu()
    del tree, hidden
    terms = max(zcfg.d_ff, zcfg.d_inner, HYB_F32_PROMPT + HYB_NEW)
    tol = f32_tol(terms, HYB_F32_LAYERS)
    tscale = tf.abs().max().item()
    tdiff = {name: (lg - tf).abs().max().item() for name, (_, lg) in zruns.items()}
    same_tokens = torch.equal(zruns["cached"][0], zruns["factorized"][0])
    top2 = zruns["cached"][1].topk(2, dim=-1).values
    emit(phase="hybrid", arch=HYBRID, step="float32 parity", layers=HYB_F32_LAYERS,
         prompt=HYB_F32_PROMPT, new_tokens=HYB_NEW, identical=same_tokens, wall_s=zwall,
         min_top2_margin=(top2[..., 0] - top2[..., 1]).min().item(),
         launches={k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_fwd", "ssd_scan")},
         launches_planned=want_all, teacher_forced_max_abs_diff=tdiff, scale=tscale,
         summed_terms=terms, tol=tol)
    if not same_tokens or not max(tdiff.values()) <= tol * tscale:
        fail(f"{HYBRID} float32: tokens identical {same_tokens}, decode logits {tdiff} from "
             f"the teacher-forced forward's (tol {tol} x {tscale})")
    for k, d in (("mpo_linear_fwd_mma", f32_mma), ("mpo_linear_fwd", cuda_core),
                 ("ssd_scan", f32_ssd)):
        if counts[k]:
            d[f"{HYBRID} float32 {HYB_F32_LAYERS} layers (two runs)"] = counts[k]
    del z32, zruns
    torch.cuda.empty_cache()

    # (d) full width, bf16, HYB_TRAIN_LAYERS layers (3 segments: shared block
    # 0 takes two uses): LFA at 2 x 512, then preempted and resumed
    zt_cfg = dataclasses.replace(zcfg, num_layers=HYB_TRAIN_LAYERS)
    zft = dict(mode="lfa", seq_len=HYB_TRAIN_SEQ, batch_size=HYB_TRAIN_BATCH, log_every=1)
    zt = Session.init(zt_cfg, seed=SEED, init_device="cuda")
    bwd_plan = hyb_train_bwd(zt, ztok)
    central = {k: v.clone() for k, v in zt.model.state_dict().items() if k.endswith(".central")}
    zt.finetune(steps=1, seed=SEED + 1, **zft)              # warm-up, not counted
    ssm_zero()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = sync_clock()
    rep = zt.finetune(steps=HYB_TRAIN_STEPS, seed=SEED, **zft)
    zt_s = sync_clock() - t0
    counts = ssm_counts()
    losses = [h["loss"] for h in rep["history"]]
    unchanged = all(torch.equal(v, zt.model.state_dict()[k]) for k, v in central.items())
    emit(phase="hybrid", step="finetune lfa", arch=HYBRID, layers=HYB_TRAIN_LAYERS,
         dtype=zt_cfg.dtype, remat=zt_cfg.remat, batch=HYB_TRAIN_BATCH, seq_len=HYB_TRAIN_SEQ,
         steps=HYB_TRAIN_STEPS, ms_per_step=1e3 * zt_s / HYB_TRAIN_STEPS,
         tokens_per_s=ztok * HYB_TRAIN_STEPS / zt_s,
         peak_mem_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         trainable=rep["trainable"], total=rep["total"], launches=counts,
         launches_per_step={k: v / HYB_TRAIN_STEPS for k, v in counts.items()},
         cores_bwd_planned_per_step=bwd_plan, central_cores=len(central),
         central_unchanged=unchanged)
    if len(losses) != HYB_TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"{HYBRID} fine-tuning: losses {losses}")
    if not central or not unchanged:
        fail(f"{HYBRID} fine-tuning: a central core changed under LFA")
    if (rep["trainable"], rep["total"]) != HYB_LFA_COUNTS:
        fail(f"{HYBRID} fine-tuning: {rep['trainable']} of {rep['total']} trainable, expected "
             f"{HYB_LFA_COUNTS}")
    if set(bwd_plan) != {"mamba/out_proj", "shared_attn/mlp/w_up", "shared_attn/mlp/w_down"}:
        fail(f"{HYBRID} fine-tuning: the cores backward is planned at {bwd_plan}")
    per_step = sum(bwd_plan.values())
    if (counts["mpo_linear_bwd_cores"] != per_step * HYB_TRAIN_STEPS
            or counts["ssd_scan_bwd"] != HYB_TRAIN_LAYERS * HYB_TRAIN_STEPS
            or counts["ssd_scan"] != 2 * HYB_TRAIN_LAYERS * HYB_TRAIN_STEPS):
        fail(f"{HYBRID} fine-tuning: launches {counts}; a step plans {per_step} cores-backward "
             f"calls, {HYB_TRAIN_LAYERS} SSD backward and {2 * HYB_TRAIN_LAYERS} SSD forward "
             "(remat)")
    hyb_gate(f"{HYBRID} finetune lfa ({HYB_TRAIN_LAYERS} layers)", counts,
             ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores", "ssd_scan", "ssd_scan_bwd"))
    del zt, central
    torch.cuda.empty_cache()
    # a run preempted at step 2 and resumed, against one straight through, at
    # HYB_LIFE_LAYERS layers (one segment)
    zl_cfg = dataclasses.replace(zcfg, num_layers=HYB_LIFE_LAYERS)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_hybrid_"))
    try:
        a = Session.init(zl_cfg, seed=SEED, init_device="cuda")
        a.finetune(steps=HYB_TRAIN_STEPS, ckpt_dir=str(tmp / "a"), seed=SEED, **zft)
        pa = params_of(a)
        del a
        torch.cuda.empty_cache()
        b = Session.init(zl_cfg, seed=SEED, init_device="cuda")
        with FLT.fault_scope(FLT.FaultPlan(preempt_finetune_step=2)):
            expect_raise(FLT.Preemption, lambda: b.finetune(
                steps=HYB_TRAIN_STEPS, ckpt_dir=str(tmp / "b"), seed=SEED, **zft),
                f"{HYBRID} preempted finetune")
        drained = CKM.CheckpointManager(str(tmp / "b")).latest_step()
        ssm_zero()
        t0 = sync_clock()
        b.finetune(steps=HYB_TRAIN_STEPS, ckpt_dir=str(tmp / "b"), seed=SEED, **zft)
        resume_s = sync_clock() - t0
        counts = ssm_counts()
        with np.load(tmp / "a" / f"step_{HYB_TRAIN_STEPS}" / "arrays.npz") as za, \
                np.load(tmp / "b" / f"step_{HYB_TRAIN_STEPS}" / "arrays.npz") as zb:
            keys = sorted(za.files)
            differ = [k for k in keys if not np.array_equal(za[k], zb[k])]
            same_keys = keys == sorted(zb.files)
        params_equal = same(pa, params_of(b))
        emit(phase="hybrid", step="finetune resume", arch=HYBRID, layers=HYB_LIFE_LAYERS,
             preempted_at=2,
             latest_step_after_preemption=drained, resumed_s=resume_s, launches_resumed=counts,
             arrays=len(keys), arrays_differing=differ, params_bit_identical=params_equal)
        if drained != 2:
            fail(f"{HYBRID} preempted finetune: latest step {drained}, expected 2")
        if not same_keys or differ or not params_equal:
            fail(f"{HYBRID} finetune resume: arrays differing {differ}, same keys {same_keys}, "
                 f"params bit-identical {params_equal}")
        if counts["ssd_scan_bwd"] != HYB_LIFE_LAYERS * (HYB_TRAIN_STEPS - 2):
            fail(f"{HYBRID} finetune resume: {counts['ssd_scan_bwd']} SSD backward launches")
        hyb_gate(f"{HYBRID} finetune resumed", counts, ("mpo_linear_bwd_cores", "ssd_scan_bwd"))
        del b, pa
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()

    # (e) the lifecycle at HYB_LIFE_LAYERS layers: from_dense of an exact tree
    # made on the card, 2 LFA steps, one squeeze iteration against its float64
    # recount, the result served both ways under (c)'s gates
    zsrc = Session.init(zl_cfg, seed=SEED, init_device="cuda")
    zdense = exact_dense(zsrc.params)
    del zsrc
    torch.cuda.empty_cache()
    t0 = sync_clock()
    zl = Session.from_dense(zdense, zl_cfg)
    conv_s = sync_clock() - t0
    del zdense
    torch.cuda.empty_cache()
    rep = zl.report()
    emit(phase="hybrid", step="from_dense exact", arch=HYBRID, layers=HYB_LIFE_LAYERS,
         matrices=rep["stages"][-1]["matrices"], from_dense_s=conv_s,
         conversion_rel_err=zl.conversion_report,
         conversion_max_rel_err=rep["conversion_max_rel_err"], tol=EXACT_TOL)
    if not rep["conversion_max_rel_err"] <= EXACT_TOL:
        fail(f"{HYBRID} from_dense of an exact tree: error {rep['conversion_max_rel_err']}")
    ssm_zero()
    t0 = sync_clock()
    rep = zl.finetune(steps=2, seed=SEED, **zft)
    lt_s = sync_clock() - t0
    counts = ssm_counts()
    losses = [h["loss"] for h in rep["history"]]
    emit(phase="hybrid", step="lifecycle finetune lfa", arch=HYBRID, layers=HYB_LIFE_LAYERS,
         steps=2, ms_per_step=1e3 * lt_s / 2, losses=losses, launches=counts)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{HYBRID} lifecycle fine-tuning: losses {losses}")
    hyb_gate(f"{HYBRID} lifecycle finetune lfa ({HYB_LIFE_LAYERS} layers)", counts,
             ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores", "ssd_scan", "ssd_scan_bwd"))
    pre = lightweight.tree_map(lambda t: t.detach().clone(), zl.params)
    rho0 = SQ.model_compression_ratio(zl.params)
    ssm_zero()
    t0 = sync_clock()
    evs = zl.squeeze(step=1, max_iters=1, finetune_steps=1, seq_len=HYB_TRAIN_SEQ,
                     batch_size=HYB_TRAIN_BATCH, delta=1.0)
    sq_s = sync_clock() - t0
    counts = ssm_counts()
    rho1 = SQ.model_compression_ratio(zl.params)
    for ev in evs:
        rc = check_event(ev, pre)
        emit(phase="hybrid", step="squeeze iteration", arch=HYBRID,
             layer="/".join(ev.layer[:-1]), bond=ev.bond, new_dim=ev.new_dim,
             predicted_error=ev.predicted_error, metric=ev.metric, seconds=ev.seconds, **rc)
    del pre
    emit(phase="hybrid", step="squeeze", arch=HYBRID, s=sq_s, events=len(evs),
         rho_before=rho0, rho_after=rho1, launches=counts)
    if len(evs) != 1 or not rho1 < rho0:
        fail(f"{HYBRID} squeeze: {len(evs)} events, rho {rho0} -> {rho1}")
    hyb_gate(f"{HYBRID} squeeze (re-tune and evaluations)", counts,
             ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores", "ssd_scan_bwd"))
    for wc in (True, False):
        handle, _, _ = hyb_serve(zl, f"{HYBRID} lifecycle ({HYB_LIFE_LAYERS} layers)", wc)
        zl._serve.clear()
        del handle
    del zl
    torch.cuda.empty_cache()
    emit(phase="hybrid", s=time.perf_counter() - z_t0)

    # ---- 15. encdec: whisper-tiny's encoder, cross-attention decoder and frame inputs ----
    from repro_torch.models import whisper as WH
    w_t0 = time.perf_counter()
    wcfg = configs.get_config(ENCDEC)
    wrows = ENC_BATCH * wcfg.frontend_len             # the encoder's rows at batch 8
    enc = {}                 # kernel -> {encdec path: launches}, for the kernels line

    def enc_gate(path, counts, want):
        """Exactly the MPO-linear launches ``want`` names (forwards and the
        cores backward), no plain version; the launches kept for the kernels
        line."""
        keys = ("mpo_linear_fwd_mma", "mpo_linear_fwd", "mpo_linear_bwd_cores")
        got = {k: counts[k] for k in keys}
        plain = sum(counts[k] for k in ssm_plains)
        if got != {k: want.get(k, 0) for k in keys} or plain:
            fail(f"{path}: launches {got}, plain-version calls {plain}; the plans name {want}")
        for k in keys:
            if counts[k]:
                enc.setdefault(k, {})[path] = counts[k]
        return got

    # (a) the kernels at whisper-tiny's shapes against their plain versions:
    # the encoder's layer 0 of a model drawn on the card (served in (c),
    # fine-tuned in (e), the lifecycle's source in (f)); the float32 forward
    # (csrc/mpo_linear.cu: no bf16 route takes these) at a decode step's 8
    # rows and the encoder's 8 x 1500, the cores backward at the decoder's
    # 8 x 448 and the encoder's 8 x 1500; the tied head in bf16
    ws = Session.init(wcfg, seed=SEED, init_device="cuda")
    wm = {name: [c[0] for c in cores_to_list(_at(ws.params, ("encoder",) + path)["cores"])]
          for name, path in (("attn", ("attn", "wq")), ("w_up", ("mlp", "w_up")),
                             ("w_down", ("mlp", "w_down")))}
    for name, cores32 in wm.items():
        for m in (8, wrows):
            results[("mpo", ENCDEC, name, m, "float32")] = fwd_case(
                f"{ENCDEC} {name}", cores32, m, "float32", phase="encdec",
                reps=3 if m == wrows else 10)
        for m in (ENC_BATCH * ENC_MAX_LEN, wrows):
            results[("bwd", ENCDEC, name, m, "float32")] = bwd_case(
                f"{ENCDEC} {name}", cores32, m, "float32", phase="encdec", dw_gate=False,
                tol=f32_tol(m) if m > 3072 else None)
    # the tied head at the rows each path gives it, on the tensor-core kernel
    # in both dtypes (float32 as its three-term split): E^T (384 -> 51968)
    # at a serving step's batch rows and an LFA step's tokens, E's own cores
    # (51968 -> 384: the head's dL/dx, summing 51968 terms an output) and the
    # cores backward at an LFA step's tokens (bf16 8 x 448, float32
    # ENC_F32_BATCH x 448)
    wembed = cores_to_list(ws.params["embed"]["cores"])
    whead = mpo.transpose_cores(wembed)
    vocab_terms = math.prod(c.shape[1] for c in wembed)
    for hdt, hbatch in (("bfloat16", ENC_BATCH), ("float32", ENC_F32_BATCH)):
        htok = hbatch * ENC_MAX_LEN
        for m in (hbatch, htok):
            results[("mpo", ENCDEC, "head", m, hdt)] = fwd_case(
                f"{ENCDEC} head", whead, m, hdt, phase="encdec")
        results[("mpo", ENCDEC, "embed", htok, hdt)] = fwd_case(
            f"{ENCDEC} head dL/dx (E)", wembed, htok, hdt, phase="encdec",
            tol=f32_tol(vocab_terms) if hdt == "float32" else None)
        results[("bwd", ENCDEC, "head", hdt)] = bwd_case(
            f"{ENCDEC} head", whead, htok, hdt, phase="encdec", dw_gate=False)
    del wm, wembed, whead
    torch.cuda.empty_cache()

    # (b) the smoke model in float32, every matmul in the kernel mode, on the
    # card against the CPU: prefill and decode logits (the card fed the CPU's
    # tokens), one train step's gradients of every leaf, a 3-step loss trajectory
    wsmoke = kernel_mode(configs.smoke_config(ENCDEC))
    srng = np.random.default_rng(SEED + 8)
    wsb = {"tokens": srng.integers(0, wsmoke.vocab_size, (4, 12)).astype(np.int32),
           "frames": srng.normal(size=(4, wsmoke.frontend_len, wsmoke.d_model))
           .astype(np.float32)}

    def enc_smoke(device, feed=None):
        ss = Session.init(wsmoke, seed=SEED, device=device)
        ssm_zero()
        h = ss.serve(4, 24, weight_cache=False)
        steps = [h.prefill(wsb)[:, -1].float().cpu()]
        toks = []
        for k in range(4):
            tok = (torch.argmax(steps[-1], -1)[:, None].to(torch.int32) if feed is None
                   else feed[:, k:k + 1])
            toks.append(tok)
            steps.append(h.decode(tok)[1][:, -1].float().cpu())
        serve_counts = hyb_counts()
        ssm_zero()
        seen = []
        rec_opt = OPT.Optimizer(init=lambda p: OPT.OptState(0, None),
                                update=lambda g, st, p: seen.append(g) or st)
        step = TS.make_train_step(ss.model, rec_opt, ss._default_loss_fn())
        batch = {k: torch.as_tensor(v).to(device)
                 for k, v in ss._default_batch_fn(12, 4, SEED)(0).items()}
        step(TS.TrainState(ss.params, rec_opt.init(ss.params)), batch)
        grads = [g.detach().cpu() for g in lightweight.leaves(seen[0])]
        hist = ss.finetune(steps=3, seq_len=12, batch_size=4, log_every=1)["history"]
        if device == "cuda":
            got = gate_routes(f"the float32 smoke {ENCDEC} serving on the card", serve_counts,
                              ss.params, train=False)
            counts = hyb_counts()
            got_t = gate_routes(f"the float32 smoke {ENCDEC} train steps on the card", counts,
                                ss.params, train=True, tied_head=True)
            if not counts["mpo_linear_bwd_cores"] or any(counts[k] for k in ssm_plains):
                fail(f"the float32 smoke {ENCDEC} on the card: train steps {counts}")
            for where, g in ((f"smoke {ENCDEC} serve", got),
                             (f"smoke {ENCDEC} train (4 steps)", got_t)):
                for k, d in (("mpo_linear_fwd", cuda_core), ("mpo_linear_fwd_mma", f32_mma)):
                    if g[k]:
                        d[where] = g[k]
            f32_bwd[f"smoke {ENCDEC} train (4 steps)"] = counts["mpo_linear_bwd_cores"]
        return torch.stack(steps, 1), torch.cat(toks, 1), grads, [h["loss"] for h in hist]

    cpu = enc_smoke("cpu")
    card = enc_smoke("cuda", feed=cpu[1].to(dev))
    ldiff = (card[0] - cpu[0]).abs().max().item()
    lscale = cpu[0].abs().max().item()
    gdiff = max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
                for a, b in zip(card[2], cpu[2]))
    hdiff = max(abs(a - b) / abs(b) for a, b in zip(card[3], cpu[3]))
    emit(phase="encdec", smoke=ENCDEC, mode="kernel", dtype="float32",
         card_vs_cpu_logits_diff=ldiff, scale=lscale, tol=SMOKE_TOL, leaves=len(card[2]),
         card_vs_cpu_grad_rel_diff=gdiff, card_vs_cpu_loss_rel_diff=hdiff,
         losses_card=card[3], losses_cpu=cpu[3], train_tol=TRAIN_TOL)
    if ldiff > SMOKE_TOL * lscale or not gdiff <= TRAIN_TOL or not hdiff <= TRAIN_TOL:
        fail(f"smoke {ENCDEC} on the card differs from the CPU: logits {ldiff} (scale "
             f"{lscale}), grads {gdiff}, losses {card[3]} vs {cpu[3]}")
    del card, cpu

    # (c) bf16 serve(8, 448) from 8 clips of 1500 frames and 64-token prompts,
    # 32 new, with the weight cache and factorized: the forward launched
    # exactly as the plans name it (bf16 sends no layer matrix to a kernel:
    # only the factorized tied head runs one), no plain call
    wrng = np.random.default_rng(SEED + 9)
    wprompts = wrng.integers(0, wcfg.vocab_size, (ENC_BATCH, ENC_PROMPT)).astype(np.int32)
    wframes = wrng.normal(size=(ENC_BATCH, wcfg.frontend_len, wcfg.d_model)).astype(np.float32)

    def enc_serve(sess, what, wc):
        handle, per_prefill, per_decode, _ = serve_run(
            sess, what, wprompts, ENC_MAX_LEN, ("mpo_linear_fwd_mma",), new_tokens=ENC_NEW,
            extra={"frames": wframes}, weight_cache=wc)
        modes, want = serve_plan(sess.engine, sess.params, sess.cfg, ENC_BATCH, ENC_PROMPT,
                                  "bfloat16", weight_cache=wc)
        llm_gate(f"{what} weight_cache={wc} prefill", per_prefill,
                 {k: v[0] for k, v in want.items()})
        llm_gate(f"{what} weight_cache={wc} decode", per_decode,
                 {k: v[1] * (ENC_NEW - 1) for k, v in want.items()})
        n = per_prefill["mpo_linear_fwd_mma"] + per_decode["mpo_linear_fwd_mma"]
        if n:
            enc.setdefault("mpo_linear_fwd_mma", {})[f"{what} serve weight_cache={wc}"] = n
        emit(phase="encdec", arch=ENCDEC, step="bf16 serve plans", what=what, weight_cache=wc,
             modes=modes, launches_planned=want,
             launches={"prefill": {k: per_prefill[k] for k in ("mpo_linear_fwd_mma",
                                                               "mpo_linear_fwd")},
                       "decode": {k: per_decode[k] for k in ("mpo_linear_fwd_mma",
                                                             "mpo_linear_fwd")}})
        return handle

    for wc in (True, False):
        enc_serve(ws, ENCDEC, wc)
        ws._serve.clear()
    wdense = exact_dense(ws.params)                   # (f)'s source, before (e) tunes ws
    torch.cuda.empty_cache()

    # (d) float32 from ENC_F32_BATCH clips, with the weight cache and
    # factorized: the same tokens, every decode step's logits within f32_tol
    # of the teacher-forced forward's, the forwards launched exactly as the
    # plans name them (the factorized encoder, and the cross-attention K/V a
    # decode step recomputes, on csrc/mpo_linear.cu)
    w32cfg = dataclasses.replace(wcfg, dtype="float32")
    w32 = Session.init(w32cfg, seed=SEED, init_device="cuda")
    b32 = {"tokens": wprompts[:ENC_F32_BATCH], "frames": wframes[:ENC_F32_BATCH]}
    wruns, wwall = {}, {}
    ssm_zero()
    for name, wc in (("cached", True), ("factorized", False)):
        t0 = sync_clock()
        h = w32.serve(ENC_F32_BATCH, ENC_MAX_LEN, weight_cache=wc)
        lg = h.prefill(b32)
        steps = [lg[:, -1]]
        tok = torch.argmax(lg[:, -1], -1)[:, None].to(torch.int32)
        toks = [tok]
        for _ in range(ENC_NEW - 1):
            tok, lg = h.decode(tok)
            toks.append(tok)
            steps.append(lg[:, -1])
        wruns[name] = (torch.cat(toks, 1).cpu(), torch.stack(steps, 1).float().cpu())
        wwall[name] = sync_clock() - t0
        w32._serve.clear()
        del h
    counts = hyb_counts()
    _, want = serve_plan(w32.engine, w32.params, w32cfg, ENC_F32_BATCH, ENC_PROMPT, "float32")
    want_all = {k: v[0] + v[1] * (ENC_NEW - 1) for k, v in want.items()}
    _, want_c = serve_plan(w32.engine, w32.params, w32cfg, ENC_F32_BATCH, ENC_PROMPT,
                            "float32", weight_cache=True)
    for k, v in want_c.items():
        want_all[k] = want_all.get(k, 0) + v[0] + v[1] * (ENC_NEW - 1)
    llm_gate(f"{ENCDEC} float32 runs", counts, want_all)
    if not counts["mpo_linear_fwd"]:
        fail(f"{ENCDEC} float32 runs: csrc/mpo_linear.cu never launched ({counts})")
    seq = torch.cat([torch.as_tensor(b32["tokens"]), wruns["cached"][0][:, :-1]], 1).to(dev)
    tree = w32.model.cache_weights(w32.params)
    with torch.no_grad():
        hidden = WH.forward_hidden(tree, {"tokens": seq,
                                          "frames": torch.as_tensor(b32["frames"]).to(dev)},
                                   w32cfg, phase="prefill")
        tf = WH.logits_head(tree, hidden[:, ENC_PROMPT - 1:], w32cfg,
                            phase="prefill").float().cpu()
    del tree, hidden
    terms = max(wcfg.d_ff, wcfg.frontend_len, ENC_PROMPT + ENC_NEW)
    tol = f32_tol(terms, wcfg.num_layers + wcfg.num_enc_layers)
    tscale = tf.abs().max().item()
    tdiff = {name: (lg - tf).abs().max().item() for name, (_, lg) in wruns.items()}
    same_tokens = torch.equal(wruns["cached"][0], wruns["factorized"][0])
    top2 = wruns["cached"][1].topk(2, dim=-1).values
    # the cross-attention K/V that a factorized decode step recomputes: one
    # projection over the stored encoder output, the card's time, times the
    # 2 x 4 a step, against the factorized run's wall time a decode step
    xattn = nn.index_layer(w32.params["decoder"], 0)["xattn"]
    enc_out = torch.randn(ENC_F32_BATCH, wcfg.frontend_len, wcfg.d_model, generator=gen).to(dev)
    with torch.no_grad():
        xkv_ms = timed(lambda: L.apply_linear(xattn["wk"], enc_out, cfg=w32cfg.mpo,
                                              phase="decode"), 3)
    emit(phase="encdec", arch=ENCDEC, step="float32 parity", batch=ENC_F32_BATCH,
         prompt=ENC_PROMPT, new_tokens=ENC_NEW, identical=same_tokens, wall_s=wwall,
         min_top2_margin=(top2[..., 0] - top2[..., 1]).min().item(),
         launches={k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_fwd")},
         launches_planned=want_all, teacher_forced_max_abs_diff=tdiff, scale=tscale,
         summed_terms=terms, tol=tol, cross_kv_projection_ms=xkv_ms,
         cross_kv_ms_per_decode_step=2 * wcfg.num_layers * xkv_ms)
    if not same_tokens or not max(tdiff.values()) <= tol * tscale:
        fail(f"{ENCDEC} float32: tokens identical {same_tokens}, decode logits {tdiff} from "
             f"the teacher-forced forward's (tol {tol} x {tscale})")
    for k, d in (("mpo_linear_fwd", cuda_core), ("mpo_linear_fwd_mma", f32_mma)):
        if counts[k]:
            d[f"{ENCDEC} float32 serve (two runs)"] = counts[k]
    del wruns, enc_out
    torch.cuda.empty_cache()

    # (e) LFA: bf16 at 8 x 448 on (c)'s session (a warm-up step first), and
    # float32 at ENC_F32_BATCH x 448 on (d)'s: finite losses, central cores
    # unchanged, the reference's trainable count, the forwards and the cores
    # backward launched exactly as the train plans name them; a float32 run
    # preempted at step 2 and resumed, bit for bit against (d)'s run straight
    # through (both checkpointed only at their end)
    wft = dict(mode="lfa", seq_len=ENC_MAX_LEN, log_every=1)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_encdec_"))
    try:
        for sess, batch in ((ws, ENC_BATCH), (w32, ENC_F32_BATCH)):
            dt = sess.cfg.dtype
            planned, want = encdec_train_launches(sess.engine, sess.params, sess.cfg, batch,
                                                  ENC_MAX_LEN, dt, ENC_TRAIN_STEPS)
            central = {k: v.clone() for k, v in sess.model.state_dict().items()
                       if k.endswith(".central")}
            kw = dict(wft, batch_size=batch)
            if dt == "bfloat16":
                sess.finetune(steps=1, seed=SEED + 1, **kw)         # warm-up, not counted
            else:
                kw["ckpt_dir"] = str(tmp / "straight")
            ssm_zero()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = sync_clock()
            rep = sess.finetune(steps=ENC_TRAIN_STEPS, seed=SEED, **kw)
            ft_s = sync_clock() - t0
            counts = hyb_counts()
            losses = [h["loss"] for h in rep["history"]]
            unchanged = all(torch.equal(v, sess.model.state_dict()[k])
                            for k, v in central.items())
            emit(phase="encdec", step="finetune lfa", arch=ENCDEC, dtype=dt,
                 remat=sess.cfg.remat, batch=batch, seq_len=ENC_MAX_LEN,
                 frames=wcfg.frontend_len, steps=ENC_TRAIN_STEPS,
                 ms_per_step=1e3 * ft_s / ENC_TRAIN_STEPS,
                 timed_with_final_checkpoint="ckpt_dir" in kw,
                 peak_mem_bytes=torch.cuda.max_memory_allocated(), mem_before_bytes=held,
                 losses=losses, trainable=rep["trainable"], total=rep["total"],
                 launches={k: counts[k] for k in ("mpo_linear_fwd_mma", "mpo_linear_fwd",
                                                  "mpo_linear_bwd_cores")},
                 launches_planned=want, cores_bwd_planned_per_step=planned,
                 central_cores=len(central), central_unchanged=unchanged)
            if len(losses) != ENC_TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
                fail(f"{ENCDEC} {dt} fine-tuning: losses {losses}")
            if not central or not unchanged:
                fail(f"{ENCDEC} {dt} fine-tuning: a central core changed under LFA")
            if (rep["trainable"], rep["total"]) != ENC_LFA_COUNTS:
                fail(f"{ENCDEC} {dt} fine-tuning: {rep['trainable']} of {rep['total']} "
                     f"trainable, expected {ENC_LFA_COUNTS}")
            if not want.get("mpo_linear_bwd_cores"):
                fail(f"{ENCDEC} {dt} fine-tuning: no matrix plans the cores backward")
            got = enc_gate(f"{ENCDEC} {dt} finetune lfa ({batch} x {ENC_MAX_LEN})", counts,
                           want)
            if dt == "float32":
                f32_bwd[f"{ENCDEC} float32 finetune lfa"] = got["mpo_linear_bwd_cores"]
                for k, d in (("mpo_linear_fwd", cuda_core), ("mpo_linear_fwd_mma", f32_mma)):
                    if got[k]:
                        d[f"{ENCDEC} float32 finetune lfa"] = got[k]
            del central
        pa = params_of(w32)
        del sess, w32
        torch.cuda.empty_cache()
        b = Session.init(w32cfg, seed=SEED, init_device="cuda")
        kw = dict(wft, batch_size=ENC_F32_BATCH, ckpt_dir=str(tmp / "resumed"))
        with FLT.fault_scope(FLT.FaultPlan(preempt_finetune_step=2)):
            expect_raise(FLT.Preemption, lambda: b.finetune(steps=ENC_TRAIN_STEPS, seed=SEED,
                                                            **kw), f"{ENCDEC} preempted finetune")
        drained = CKM.CheckpointManager(str(tmp / "resumed")).latest_step()
        b.finetune(steps=ENC_TRAIN_STEPS, seed=SEED, **kw)
        with np.load(tmp / "straight" / f"step_{ENC_TRAIN_STEPS}" / "arrays.npz") as za, \
                np.load(tmp / "resumed" / f"step_{ENC_TRAIN_STEPS}" / "arrays.npz") as zb:
            keys = sorted(za.files)
            differ = [k for k in keys if not np.array_equal(za[k], zb[k])]
            same_keys = keys == sorted(zb.files)
        params_equal = same(pa, params_of(b))
        emit(phase="encdec", step="finetune resume", arch=ENCDEC, dtype="float32",
             preempted_at=2, latest_step_after_preemption=drained, arrays=len(keys),
             arrays_differing=differ, params_bit_identical=params_equal)
        if drained != 2 or not same_keys or differ or not params_equal:
            fail(f"{ENCDEC} finetune resume: drained at {drained}, arrays differing {differ}, "
                 f"same keys {same_keys}, params bit-identical {params_equal}")
        del b, pa
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del ws
    torch.cuda.empty_cache()

    # (f) the lifecycle at full depth, bf16: from_dense of (a)'s exact tree
    # (made on the card), 2 LFA steps, one squeeze iteration against its
    # float64 recount, served both ways under (c)'s gates, saved and
    # restored: the same greedy tokens
    t0 = sync_clock()
    wl = Session.from_dense(wdense, wcfg)
    conv_s = sync_clock() - t0
    del wdense
    rep = wl.report()
    emit(phase="encdec", step="from_dense exact", arch=ENCDEC,
         matrices=rep["stages"][-1]["matrices"], from_dense_s=conv_s,
         conversion_rel_err=wl.conversion_report,
         conversion_max_rel_err=rep["conversion_max_rel_err"], tol=EXACT_TOL)
    if not rep["conversion_max_rel_err"] <= EXACT_TOL:
        fail(f"{ENCDEC} from_dense of an exact tree: error {rep['conversion_max_rel_err']}")
    _, want = encdec_train_launches(wl.engine, wl.params, wcfg, ENC_BATCH, ENC_MAX_LEN,
                                    "bfloat16", 2)
    ssm_zero()
    t0 = sync_clock()
    rep = wl.finetune(steps=2, seed=SEED, batch_size=ENC_BATCH, **wft)
    lt_s = sync_clock() - t0
    counts = hyb_counts()
    losses = [h["loss"] for h in rep["history"]]
    emit(phase="encdec", step="lifecycle finetune lfa", arch=ENCDEC, steps=2,
         ms_per_step=1e3 * lt_s / 2, losses=losses, launches=counts)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{ENCDEC} lifecycle fine-tuning: losses {losses}")
    enc_gate(f"{ENCDEC} bfloat16 lifecycle finetune lfa", counts, want)
    pre = lightweight.tree_map(lambda t: t.detach().clone(), wl.params)
    rho0 = SQ.model_compression_ratio(wl.params)
    ssm_zero()
    t0 = sync_clock()
    evs = wl.squeeze(step=1, max_iters=1, finetune_steps=1, seq_len=ENC_MAX_LEN,
                     batch_size=ENC_BATCH, delta=1.0)
    sq_s = sync_clock() - t0
    counts = hyb_counts()
    rho1 = SQ.model_compression_ratio(wl.params)
    for ev in evs:
        rc = check_event(ev, pre)
        emit(phase="encdec", step="squeeze iteration", arch=ENCDEC,
             layer="/".join(ev.layer[:-1]), bond=ev.bond, new_dim=ev.new_dim,
             predicted_error=ev.predicted_error, metric=ev.metric, seconds=ev.seconds, **rc)
    del pre
    emit(phase="encdec", step="squeeze", arch=ENCDEC, s=sq_s, events=len(evs),
         rho_before=rho0, rho_after=rho1, launches=counts)
    if len(evs) != 1 or not rho1 < rho0:
        fail(f"{ENCDEC} squeeze: {len(evs)} events, rho {rho0} -> {rho1}")
    if any(counts[k] for k in ssm_plains) or not counts["mpo_linear_bwd_cores"]:
        fail(f"{ENCDEC} squeeze: a plain version ran, or the re-tune no cores backward "
             f"({counts})")
    for k in ("mpo_linear_fwd_mma", "mpo_linear_bwd_cores"):
        enc.setdefault(k, {})[f"{ENCDEC} bfloat16 squeeze (re-tune and evaluations)"] = counts[k]
    for wc in (True, False):
        enc_serve(wl, f"{ENCDEC} lifecycle", wc)
        wl._serve.clear()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_encdec_session_"))
    try:
        inputs = {"tokens": wprompts, "frames": wframes}
        want_tokens = wl.serve(ENC_BATCH, ENC_MAX_LEN).generate(inputs, ENC_NEW).cpu()
        t0 = sync_clock()
        wl.save(str(tmp / "s"))
        save_s = sync_clock() - t0
        r = Session.restore(str(tmp / "s"))
        restore_s = sync_clock() - t0 - save_s
        got_tokens = r.serve(ENC_BATCH, ENC_MAX_LEN).generate(inputs, ENC_NEW).cpu()
        same_leaves = same(params_of(wl), params_of(r))
        emit(phase="encdec", step="save/restore", arch=ENCDEC, save_s=save_s,
             restore_s=restore_s, dir_bytes=dir_bytes(tmp / "s"), leaves_equal=same_leaves,
             tokens_identical=torch.equal(got_tokens, want_tokens),
             stage=r.stage, weights_version=r.weights_version)
        if not same_leaves or not torch.equal(got_tokens, want_tokens) or \
                (r.stage, r.weights_version) != (wl.stage, wl.weights_version):
            fail(f"{ENCDEC} save/restore: leaves equal {same_leaves}, tokens "
                 f"{got_tokens.tolist()} vs {want_tokens.tolist()}, stage/version "
                 f"{(r.stage, r.weights_version)} vs {(wl.stage, wl.weights_version)}")
        del r
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del wl
    torch.cuda.empty_cache()
    emit(phase="encdec", s=time.perf_counter() - w_t0)

    # ---- 16. the measured plans ----
    for k, paths in autotune_phase().items():
        for path, n in paths.items():
            by_path.setdefault(k, {})[f"autotune {path}"] = n
            path_launches[k] = path_launches.get(k, 0) + n

    # ---- 17. meshes ----
    for k, paths in mesh_phase().items():
        for path, n in paths.items():
            if k == "flash_decode_attention" and "float32" in path:
                f32_flash[path] = n                 # the float32 entry's launches
                continue
            by_path.setdefault(k, {})[path] = n
            path_launches[k] = path_launches.get(k, 0) + n

    # ---- 18. the static analysis and the dry run against the card ----
    analysis_phase(str(ana_tmp / "phase5"), 1e3 * train_s / TRAIN_STEPS, static_job)

    # ---- 19. the kernels line: one entry per kernel and dtype ----
    fk = results[("flash", "path", "bfloat16")]
    entry = lambda name, route, source, replaces, rec, case, launches, **kw: dict(
        name=name, route=route, source=source, replaces=replaces, launches=launches,
        max_abs_err=rec["max_abs_err"], ms=rec["kernel_ms"], plain_ms=rec["plain_ms"],
        bound_ms=rec["bound_ms"], bound_by=rec["bound_by"], library_ms=rec["library_ms"],
        case=case, dtype=rec["dtype"], **kw)
    fwd = ("src/repro_torch/csrc/mpo_linear_mma.cu", "src/repro/kernels/mpo_linear.py:216")
    bwd = ("src/repro_torch/csrc/mpo_linear_bwd.cu", "src/repro/kernels/mpo_linear.py:303")
    ssd = ("src/repro_torch/csrc/ssd_scan.cu", "src/repro/kernels/ssd_scan.py:60")
    ssdb = ("src/repro_torch/csrc/ssd_scan_bwd.cu", "none: the reference has no Pallas "
            "backward and differentiates its plain ssd_chunked (src/repro/models/mamba.py:37)")
    line = [
        entry("mpo_linear_fwd_mma", "cuda", *fwd, results[("mpo", "attn", 8, "bfloat16")],
              "bert-base attention matrix, M=8 (a decode step), bfloat16",
              path_launches["mpo_linear_fwd_mma"],
              launches_by_path=by_path["mpo_linear_fwd_mma"]),
        entry("mpo_linear_fwd_mma", "cuda", *fwd, results[("mpo", "attn", 8, "float32")],
              "bert-base attention matrix, M=8 (a decode step), float32", sum(f32_mma.values()),
              launches_by_path=f32_mma),
        entry("mpo_linear_fwd", "cuda", "src/repro_torch/csrc/mpo_linear.cu", fwd[1],
              results[("mpo", "gemma2-27b", "w_down", LLM_F32_CASE_M, "float32")],
              f"gemma2-27b w_down (36864 -> 4608: the tensor-core plan refuses it), "
              f"M={LLM_F32_CASE_M}, float32", sum(cuda_core.values()),
              launches_by_path=cuda_core,
              smoke_case={k: results[("mpo", "smoke wq", 48, "float32")][k] for k in (
                  "matrix", "M", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
                  "library_ms")}),
        entry("mpo_linear_fwd", "cuda", "src/repro_torch/csrc/mpo_linear.cu", fwd[1],
              results[("mpo", "gemma2-27b", "w_down", LLM_F32_PROMPT["gemma2-27b"][1],
                       "float32")],
              f"gemma2-27b w_down, M={LLM_F32_PROMPT['gemma2-27b'][1]} (its float32 prefill "
              "of one long prompt), float32 (launches: gemma2-27b's float32 runs)",
              sum(v for k, v in cuda_core.items() if k.startswith("gemma2-27b float32")),
              launches_by_path={k: v for k, v in cuda_core.items()
                                if k.startswith("gemma2-27b float32")},
              # no path of the script launches it at qwen3's lm_head (the
              # engine plans that matrix otherwise), so its case rides here
              qwen3_lm_head_case={k: results[("mpo", "qwen3-14b", "lm_head", 2, "float32")][k]
                                  for k in ("matrix", "M", "max_abs_err", "kernel_ms",
                                            "plain_ms", "bound_ms", "bound_by",
                                            "library_ms")}),
        entry("flash_decode_attention", "cuda", "src/repro_torch/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:166", fk,
              "bert-base geometry KV=12 G=1 Dh=64 ps=16, 8 slots at 144 keys, bfloat16",
              path_launches["flash_decode_attention"], splits=fk["splits"],
              prev_ms=fk["prev_ms"], launches_by_path=by_path["flash_decode_attention"]),
        entry("flash_decode_attention", "cuda", "src/repro_torch/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:166", results[("flash", "path", "float32")],
              "bert-base geometry KV=12 G=1 Dh=64 ps=16, 8 slots at 144 keys, float32 (launches: "
              "the float32 paged serving runs, pool and fleet)", sum(f32_flash.values()),
              splits=results[("flash", "path", "float32")]["splits"],
              prev_ms=results[("flash", "path", "float32")]["prev_ms"],
              launches_by_path=f32_flash),
        entry("mpo_linear_bwd_cores", "cuda", *bwd, results[("bwd", "attn", tokens, "bfloat16")],
              f"bert-base attention matrix, M={tokens} (16 x 128 fine-tuning tokens), bfloat16",
              path_launches["mpo_linear_bwd_cores"], launches_per_call=MK.BWD_KERNELS,
              launches_by_path=by_path["mpo_linear_bwd_cores"]),
        entry("mpo_linear_bwd_cores", "cuda", *bwd, results[("bwd", "attn", tokens, "float32")],
              f"bert-base attention matrix, M={tokens}, float32 (launches: the smoke "
              "float32 train steps)", sum(f32_bwd.values()), launches_by_path=f32_bwd,
              launches_per_call=MK.BWD_KERNELS),
        entry("ssd_scan", "cuda", *ssd, results[("ssd", "path", "bfloat16")],
              f"mamba2-130m prefill: B={MAMBA_BATCH} S={MAMBA_PROMPT} H=24 P=64 N=128, "
              "chunk 128, bfloat16", path_launches["ssd_scan"],
              launches_per_call=SSD.SSD_KERNELS, launches_by_path=by_path["ssd_scan"],
              launch_ms=results[("ssd", "path", "bfloat16")]["launch_ms"]),
        entry("ssd_scan", "cuda", *ssd, results[("ssd", "path", "float32")],
              f"mamba2-130m prefill: B={MAMBA_BATCH} S={MAMBA_PROMPT}, float32 (launches: the "
              "float32 mamba2-130m serving runs and smoke train steps)", sum(f32_ssd.values()),
              launches_by_path=f32_ssd, launches_per_call=SSD.SSD_KERNELS,
              launch_ms=results[("ssd", "path", "float32")]["launch_ms"],
              tc_bound_ms=results[("ssd", "path", "float32")]["tc_bound_ms"]),
        entry("ssd_scan_bwd", "cuda", *ssdb, results[("ssd_bwd", "train", "bfloat16")],
              f"mamba2-130m fine-tuning: B={SSM_BATCH} S={SSM_SEQ} H=24 P=64 N=128, chunk 128, "
              "a random final-state cotangent, bfloat16", path_launches["ssd_scan_bwd"],
              launches_per_call=SSD.SSD_BWD_KERNELS, launches_by_path=by_path["ssd_scan_bwd"],
              launch_ms=results[("ssd_bwd", "train", "bfloat16")]["launch_ms"]),
        entry("ssd_scan_bwd", "cuda", *ssdb, results[("ssd_bwd", "train", "float32")],
              f"mamba2-130m fine-tuning: B={SSM_BATCH} S={SSM_SEQ}, float32 (launches: the "
              "smoke float32 train steps)", sum(f32_ssd_bwd.values()),
              launches_by_path=f32_ssd_bwd, launches_per_call=SSD.SSD_BWD_KERNELS,
              launch_ms=results[("ssd_bwd", "train", "float32")]["launch_ms"],
              tc_bound_ms=results[("ssd_bwd", "train", "float32")]["tc_bound_ms"]),
    ]
    stacked_path = {k: v[0] for k, v in moe_paths.items()}
    if any(v[0] != v[1] for v in moe_paths.values()):
        fail(f"stacked launches on the moe paths (measured, planned): {moe_paths}")
    m_pre, m_dec = moe_rows(l4cfg, LLM_PROMPT), moe_rows(l4cfg, 1)
    smoke_up = results[("stacked", "smoke", "w_up")]
    vlm_flash = {k: v for k, v in by_path["flash_decode_attention"].items() if LLAVA in k}
    line += [
        entry("mpo_linear_fwd_mma", "cuda", *fwd,
              results[("stacked", LLAMA4, "w_up", m_pre, "bfloat16")],
              f"{LLAMA4} w_up (5120 -> 8192), {l4cfg.num_experts} experts stacked in one "
              f"launch, M={m_pre} an expert (a prefill's capacity at 8 x 512), bfloat16",
              sum(stacked_path.values()), launches_by_path=stacked_path, stacked=True,
              planned=sum(v[1] for v in moe_paths.values()),
              note="launches: the stacked calls of the bf16 moe paths, counted where they "
                   "launch; planned: 3 a MoE layer a call"),
        entry("mpo_linear_fwd_mma", "cuda", *fwd,
              results[("stacked", LLAMA4, "w_up", m_dec, "float32")],
              f"{LLAMA4} w_up, {l4cfg.num_experts} experts stacked, M={m_dec} an expert (a "
              "decode step's capacity at batch 8), float32 (launches: the stacked calls of "
              "the float32 moe runs)",
              sum(f32_stacked.values()),
              launches_by_path=f32_stacked, stacked=True),
        entry("mpo_linear_fwd", "cuda", "src/repro_torch/csrc/mpo_linear.cu", fwd[1],
              smoke_up, f"smoke {PHI35} w_up (64 -> 128), {smoke_up['experts']} experts stacked, "
              f"M={smoke_up['M']} an expert, float32 (the tensor-core plan refuses it)",
              sum(f32_moe_core.values()),
              launches_by_path=f32_moe_core, stacked=True),
        entry("flash_decode_attention", "cuda", "src/repro_torch/csrc/decode_attention.cu",
              "src/repro/kernels/decode_attention.py:166", results[("flash", LLAVA, "bfloat16")],
              f"{LLAVA} geometry KV=8 G=7 Dh=128 ps=16, ragged, bfloat16",
              sum(vlm_flash.values()), launches_by_path=vlm_flash),
    ]
    sb16 = results[("stacked_bwd", PHI35, "w_up", "bfloat16")]
    sb32 = results[("stacked_bwd", PHI35, "w_up", "float32")]
    line += [
        entry("mpo_linear_bwd_cores", "cuda", *bwd, sb16,
              f"{PHI35} w_up (4096 -> 6400), {sb16['experts']} experts stacked in one call "
              f"({sb16['launch_sets']} launch sets of 3: groups of {sb16['group']} experts), "
              f"M={sb16['M']} an expert (a 4 x 512 fine-tuning batch's capacity), bfloat16",
              path_launches["mpo_linear_bwd_cores_stacked"],
              launches_by_path=by_path["mpo_linear_bwd_cores_stacked"], stacked=True,
              planned=bwd_per_step * (3 * MOE_TRAIN_STEPS - 4 + MESH_TRAIN_STEPS),
              launch_sets=sb16["launch_sets"],
              note="launches: the stacked calls of phase 13's bf16 fine-tuning runs (timed, "
                   "straight through, resumed) and phase 17 (g)'s on the mesh, counted where "
                   "they launch; planned: one a MoE layer's expert matrix a step"),
        entry("mpo_linear_bwd_cores", "cuda", *bwd, sb32,
              f"{PHI35} w_up, {sb32['experts']} experts stacked, M={sb32['M']} an expert, "
              "float32 (launches: the stacked calls of the smoke float32 train steps)",
              sum(f32_stacked_bwd.values()), launches_by_path=f32_stacked_bwd, stacked=True,
              launch_sets=sb32["launch_sets"]),
    ]
    mine = lambda d: {k: v for k, v in d.items() if HYBRID in k}
    in_proj_j = zcfg.d_inner * 2 + 2 * zcfg.ssm_state + zcfg.ssm_heads
    hname = f"{HYBRID} ({zcfg.d_model} -> {in_proj_j})"
    ssd_geom = (f"H={zcfg.ssm_heads} P={zcfg.ssm_head_dim} N={zcfg.ssm_state}, chunk "
                f"{zcfg.ssm_chunk}")
    line += [
        entry("mpo_linear_fwd_mma", "cuda", *fwd, results[("mpo", HYBRID, "in_proj", zrows,
                                                          "bfloat16")],
              f"{hname} in_proj, M={zrows} (a prefill of 8 x 512), bfloat16",
              sum(hyb["mpo_linear_fwd_mma"].values()), launches_by_path=hyb["mpo_linear_fwd_mma"]),
        entry("mpo_linear_fwd_mma", "cuda", *fwd, results[("mpo", HYBRID, "in_proj", zrows,
                                                          "float32")],
              f"{hname} in_proj, M={zrows}, float32 (launches: the float32 hybrid runs)",
              sum(mine(f32_mma).values()), launches_by_path=mine(f32_mma)),
        entry("mpo_linear_fwd", "cuda", "src/repro_torch/csrc/mpo_linear.cu", fwd[1],
              results[("mpo", HYBRID, "wq", 128, "float32")],
              f"{HYBRID} shared attention wq ({zcfg.d_model} -> {zcfg.d_model}: no bf16 route; "
              "float32 takes csrc/mpo_linear.cu), M=128, float32",
              sum(mine(cuda_core).values()), launches_by_path=mine(cuda_core)),
        entry("mpo_linear_bwd_cores", "cuda", *bwd, results[("bwd", HYBRID, "w_up", "bfloat16")],
              f"{HYBRID} shared w_up ({zcfg.d_model} -> {zcfg.d_ff}), M={ztok} (2 x 512 "
              "fine-tuning tokens), bfloat16", sum(hyb["mpo_linear_bwd_cores"].values()),
              launches_by_path=hyb["mpo_linear_bwd_cores"], launches_per_call=MK.BWD_KERNELS),
        entry("mpo_linear_bwd_cores", "cuda", *bwd, results[("bwd", HYBRID, "out_proj",
                                                            "float32")],
              f"{HYBRID} out_proj ({zcfg.d_inner} -> {zcfg.d_model}), M={ztok}, float32 "
              "(launches: the smoke float32 train steps)", sum(mine(f32_bwd).values()),
              launches_by_path=mine(f32_bwd), launches_per_call=MK.BWD_KERNELS),
        entry("ssd_scan", "cuda", *ssd, results[("ssd", HYBRID, "bfloat16")],
              f"{HYBRID} prefill: B={HYB_BATCH} S={HYB_PROMPT} {ssd_geom}, bfloat16",
              sum(hyb["ssd_scan"].values()), launches_by_path=hyb["ssd_scan"],
              launches_per_call=SSD.SSD_KERNELS,
              launch_ms=results[("ssd", HYBRID, "bfloat16")]["launch_ms"]),
        entry("ssd_scan", "cuda", *ssd, results[("ssd", HYBRID, "float32")],
              f"{HYBRID} prefill: B={HYB_BATCH} S={HYB_PROMPT}, float32 (launches: the float32 "
              "hybrid runs)", sum(mine(f32_ssd).values()), launches_by_path=mine(f32_ssd),
              launches_per_call=SSD.SSD_KERNELS,
              launch_ms=results[("ssd", HYBRID, "float32")]["launch_ms"]),
        entry("ssd_scan_bwd", "cuda", *ssdb, results[("ssd_bwd", HYBRID, "bfloat16")],
              f"{HYBRID} fine-tuning: B={HYB_TRAIN_BATCH} S={HYB_TRAIN_SEQ} {ssd_geom}, a "
              "random final-state cotangent, bfloat16", sum(hyb["ssd_scan_bwd"].values()),
              launches_by_path=hyb["ssd_scan_bwd"], launches_per_call=SSD.SSD_BWD_KERNELS,
              launch_ms=results[("ssd_bwd", HYBRID, "bfloat16")]["launch_ms"]),
        entry("ssd_scan_bwd", "cuda", *ssdb, results[("ssd_bwd", HYBRID, "float32")],
              f"{HYBRID} fine-tuning: B={HYB_TRAIN_BATCH} S={HYB_TRAIN_SEQ}, float32 (launches: "
              "the smoke float32 train steps)", sum(mine(f32_ssd_bwd).values()),
              launches_by_path=mine(f32_ssd_bwd), launches_per_call=SSD.SSD_BWD_KERNELS,
              launch_ms=results[("ssd_bwd", HYBRID, "float32")]["launch_ms"]),
    ]
    wmine = lambda d: {k: v for k, v in d.items() if ENCDEC in k}
    wbf16 = lambda d: {k: v for k, v in d.items() if "float32" not in k}
    wname = f"{ENCDEC} attention matrix ({wcfg.d_model} -> {wcfg.d_model}: no bf16 route)"
    line += [
        entry("mpo_linear_fwd", "cuda", "src/repro_torch/csrc/mpo_linear.cu", fwd[1],
              results[("mpo", ENCDEC, "attn", wrows, "float32")],
              f"{wname}, M={wrows} (the encoder over 8 x {wcfg.frontend_len} frames), float32 "
              "(launches: the float32 encdec runs)", sum(wmine(cuda_core).values()),
              launches_by_path=wmine(cuda_core)),
        entry("mpo_linear_bwd_cores", "cuda", *bwd,
              results[("bwd", ENCDEC, "attn", wrows, "float32")],
              f"{wname}, M={wrows}, float32 (launches: the float32 encdec train steps)",
              sum(wmine(f32_bwd).values()), launches_by_path=wmine(f32_bwd),
              launches_per_call=MK.BWD_KERNELS),
        entry("mpo_linear_fwd_mma", "cuda", *fwd,
              results[("mpo", ENCDEC, "head", ENC_BATCH, "bfloat16")],
              f"{ENCDEC} tied head ({wcfg.d_model} -> {wcfg.vocab_size}), M={ENC_BATCH} (a "
              "decode step), bfloat16 (launches: the bf16 encdec paths, where only the head "
              "has a route)", sum(wbf16(enc["mpo_linear_fwd_mma"]).values()),
              launches_by_path=wbf16(enc["mpo_linear_fwd_mma"])),
        entry("mpo_linear_fwd_mma", "cuda", *fwd,
              results[("mpo", ENCDEC, "head", ENC_F32_BATCH * ENC_MAX_LEN, "float32")],
              f"{ENCDEC} tied head, M={ENC_F32_BATCH * ENC_MAX_LEN} ({ENC_F32_BATCH} x "
              f"{ENC_MAX_LEN} fine-tuning tokens), float32 (launches: the float32 encdec paths)",
              sum(wmine(f32_mma).values()), launches_by_path=wmine(f32_mma)),
        entry("mpo_linear_bwd_cores", "cuda", *bwd, results[("bwd", ENCDEC, "head", "bfloat16")],
              f"{ENCDEC} tied head, M={ENC_BATCH * ENC_MAX_LEN} (8 x 448 fine-tuning tokens), "
              "bfloat16", sum(wbf16(enc["mpo_linear_bwd_cores"]).values()),
              launches_by_path=wbf16(enc["mpo_linear_bwd_cores"]),
              launches_per_call=MK.BWD_KERNELS),
    ]
    if any(e["launches"] == 0 for e in line):
        fail(f"a kernel of the paths never launched: {[(e['name'], e['dtype'], e['launches']) for e in line]}")
    emit(kernels=line)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
