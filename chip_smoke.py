#!/usr/bin/env python3
"""Smoke check of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It drives the port's serving path and its training path
(vision_transformers_torch_xla_tpu_torch) and imports nothing of JAX. Phases, in order; any failure exits non-zero
and no phase catches its own error:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA.
2. build: every CUDA source of the port with nvcc into build/kernels/,
   one nvcc per source, all started together; the time, registers and
   spills of the tensor-core attention sources, TMA and wgmma in bf16 and
   fp16 around csrc/hopper.cuh: csrc/attn_fwd_tc.cu (K1 and K9, and in
   K7's cast order K7 and K11), csrc/attn_bwd_tc.cu (K2) and
   csrc/hp_bwd_tc.cu (K8, K10 and K12), with their dynamic shared memory;
   and of csrc/attn_fwd.cu (K1's and K9's fp32 version, CUDA cores:
   csrc/attn_fwd_simt.cuh's attn_fwd_simt_kernel in K1's order at D <=
   256, register tiles).
3. kernel vs plain: ops/flash_attention.py::attn_fwd (the CUDA kernel),
   and hp_fwd (K9, the same launch without stats), against
   attn_fwd_reference (plain PyTorch) on seeded bf16 qkv at the train
   path's shapes (B 64 and 128, S 197, H 12, D 64), its eval batch (B 192)
   and a few other shapes of the kernel's contract, then in bf16 and fp16 at the tensor-core
   kernel's edges (TC_EDGE_SHAPES: S 17 to 1024 around its 128-row tiles,
   D 64 and 128, and head dims that take one padded copy, which must
   happen exactly when the dispatch rule says); median CUDA-event time of
   each at the main shapes.
4. model: full-width my_vit_b (gelu_tanh, avg pool, bf16 compute) built
   with use_pallas_attn, as the trainer builds it on the card, on the
   seeded weights, saved and strict-loaded through ckpt/convert.py, against
   the JAX package's fp32 golden logits (tests/data/); one forward must
   launch the kernel exactly once per block (12).
5. serve: the port's HTTP server on 127.0.0.1 with the same weights;
   /healthz, then /predict with the committed JPEGs (tests/data/serve_*.jpg).
   The server builds its model without use_pallas_attn, as the JAX server
   does, so no request may launch any kernel.
6. build: csrc/attn_bwd_tc.cu (K2 in bf16 and fp16, TMA and wgmma; its
   registers in phase 2) and csrc/attn_bwd.cu (its fp32 version: one block
   per (b, h) over register-tiled 64-row tiles), started with the others
   in phase 2; build time, registers, spills and shared memory.
7. backward kernel vs plain: ops/flash_attention.py::attn_bwd against
   attn_bwd_reference on seeded bf16 qkv and dO, with o and the row stats
   from the forward kernel (themselves held against attn_fwd_reference
   with phase 3's limits), at the train path's shapes (B 64 and 128, S 197,
   H 12, D 64), a few other shapes of the contract and phase 3's
   tensor-core edges in bf16 and fp16; every call runs twice, and the two
   runs must be bitwise equal (no float atomics); median CUDA-event time
   of each at B 64 and 128.
8. gradient: full-width my_vit_b (gelu_tanh, avg pool, drop_path 0, bf16,
   use_pallas_attn) on the phase-4 weights, one train-mode forward +
   backward on 2 seeded images with smoothed targets, against the JAX
   package's fp32 golden loss, grad norm and per-parameter grad norms
   (tests/data/); it must launch each attention kernel exactly 12 times.
9. train: the port's trainer, launch/main.py::main, on my_vit_b at batch
   128 with the recipe's flags for 3 steps and 2 eval batches (12 backward
   launches per step); then 10 steps on one fixed batch (mixup off, lr
   1e-4), whose loss must fall; then the recipe's step timed on a fixed
   device batch: median step ms, images/s, MFU and peak memory.

The long-sequence slice, vit_base_patch14_dinov2 at 518 px (S = 1370,
ops/flash_blocked.py):

10. build: csrc/flash_fwd.cu (K4) and csrc/flash_bwd.cu (K5, K6), both
    TMA + wgmma (K4, K5 and K6 in bf16 and fp16 at head dims to 256), and
    csrc/flash_blocked.cu (the rest of K4-K6 on the CUDA cores: fp32, and
    every dtype past 256) with
    csrc/flash_bwd_simt.cu and csrc/flash_fwd_simt.cu (the fp32 K5, K6 and
    K4 at head dims <= 128, register tiles) linked in, started with the
    others in phase 2; build time, registers and spills.
11. blocked kernels vs plain: flash_fwd (K4), flash_bwd_dkdv (K5) and
    flash_bwd_dq (K6) against their plain versions on seeded bf16 q, k, v,
    dO read from a (B, S, 3·H·D) buffer, at the path's shapes (B 1 and 32,
    S 1370, H 12, D 64) and others of the contract (S 1025, 2048, 4097 at
    D 128, 197); at the path's shapes the median CUDA-event time of each
    kernel, its plain version, and the yardstick
    torch.nn.functional.scaled_dot_product_attention (forward; backward),
    which the port never calls. Then K4-K6 at the rest of their contract:
    B·H = 65544 > 65535, D 48 and 96, and q, k, v (and dO) that TMA cannot
    read in place (an odd head dim, a transposed layout), which take one
    copy each.
12. model: full-width vit_base_patch14_dinov2 (token pool, bf16 compute,
    use_pallas_attn) on seeded weights (LayerScale gammas 1), saved and
    strict-loaded through ckpt/convert.py, against the JAX package's fp32
    golden logits; one forward must launch K4 exactly 12 times and K1
    never.
13. serve: the port's HTTP server with that model at 518 px; as in phase 5
    no request may launch any kernel.
14. gradient: one train-mode forward + backward of that model
    (use_pallas_attn) on 2 seeded
    images against the JAX fp32 train golden; exactly 12 launches each of
    K4, K5 and K6, each call also held against its plain version on the
    same inputs (the model's own data). Then the witness: the same step
    with the plain versions of K4-K6 swapped in, against the same golden.
15. train: launch/main.py::main on vit_base_patch14_dinov2 --input_size 518
    --global_pool token at batch 32 with the recipe's other flags (the
    model keeps its own exact GELU) for 3 steps and 2 eval batches; then
    the step timed on a fixed device batch: median ms, images/s, MFU at
    518/14 and peak memory.
The fused-backward MLP (`--pallas_mlp on`, ops/mlp_fused.py) and the
head-pair attention of `fused_attention_qkv_cols` at S <= 1024:

16. build: csrc/mlp_fused.cu (K3: TMA, mbarriers and wgmma in bf16 and
    fp16, the CUDA cores in fp32) and csrc/hp_bwd.cu (K8, K10 and K12 on
    the CUDA cores, with csrc/hp_bwd_simt.cu's fp32 kernels at D <= 128
    linked in), started with the others in phase 2; build time,
    registers, spills and shared memory.
17. K3 vs plain: ops/mlp_fused.py::fc2_bwd against fc2_bwd_reference on
    seeded bf16 dy, fc2 weight and h at the step's shapes (B 128 and 64,
    S 197, O 768, K 3072) and a few of the contract (ragged S with an odd
    B, K 256, a single short tile), each call run twice and bitwise equal;
    at the step's shapes the median
    CUDA-event time of the kernel, of its plain version, and of the
    default path's work for the same result (cuBLAS da, autograd's GELU
    backward, the fp32 bias sum: unfused_ms). No single PyTorch call
    computes K3's function, so library_ms is null. Then the kernels that
    one call of the bf16, fp16 and fp32 K3 (fc2_bwd_simt_kernel in fp32),
    of the fp32 K2, of the fp32 K1, K9, K7 and K11 at D 64, 136, 192 and
    256 (attn_fwd_simt_kernel in each cast order), of the
    fp32 K4, K5 and K6 at S 1370 on a qkv buffer's views
    (flash_fwd_simt_kernel, flash_bwd_dkdv_simt_kernel,
    flash_bwd_dq_simt_kernel) and of the fp32 K8, K10 and K12 at S 197
    (hp_bwd_stats_simt_kernel, hp_bwd_dkdv_simt_kernel and
    hp_bwd_dq_sum_kernel), and at D 192 and 256 of the bf16 and fp16 K2
    (csrc/attn_bwd_tc.cu's prep, attn_bwd_tc_dkdv_wide_kernel,
    attn_bwd_tc_dq_wide_kernel and bias sum), of the fp32 K2
    (csrc/attn_bwd_simt.cu's rows, attn_bwd_dkdv_wide_simt_kernel,
    attn_bwd_dq_sum_simt_kernel and bias sum) and of the fp32 K8, K10 and
    K12 (hp_bwd_stats_wide_simt_kernel, hp_bwd_dkdv_wide_simt_kernel,
    hp_bwd_dq_sum_kernel) launches
    (torch.profiler, in a process of its own) must be their new kernels
    alone.
17b. head dims over 128 on every route (F8), in bf16, fp16 and fp32:
    qkv_proj_attention forward and backward (K1, K2) and
    fused_attention_qkv_cols at S <= 1024 (K9, K10) at WIDE_QKV_SHAPES (D
    136 to 1024), fused_attention_qkv_cols at S 1025 and 1100 (K4-K6) at
    WIDE_LONG_SHAPES, multi_head_attention(use_pallas=True) and
    fused_attention_qkv (K7, K8, K11, K12) at D 256, driven once per dtype
    with the counts reset just before: each kernel launched exactly as
    often as the shapes say. Each route function answers as the rule
    says (K1, K9, K7-K12 on the wide tensor-core tiles of
    csrc/attn_fwd_tc.cu and csrc/hp_bwd_tc.cu, K2 on those of
    csrc/attn_bwd_tc.cu, K4, K5 and K6 on those of csrc/flash_fwd.cu and
    csrc/flash_bwd.cu, up to 256 in bf16 and fp16; fp32 and past 256 on
    the CUDA cores, the fp32 K2 to 256 on csrc/attn_bwd_simt.cu's register
    tiles), and one
    call of each kernel at D 256 (and past 256
    in bf16), traced together in one torch.profiler session per dtype (ahead
    of the trainer phases; a process's sessions stop recording after a
    few dozen), launches exactly the csrc/ kernels their routes name.
    Each held against its
    plain version at every shape within WIDE_REL of the largest magnitude
    (FP32_OUT_REL for fp32 outputs, LSE_ATOL for lse), and timed at
    WIDE_TIMED (K4-K6 WIDE_LONG_TIMED) beside its plain version and SDPA;
    each gets a line 'kernel[dtype,d256]' in the kernels JSON with the
    launches of that run; the bf16, fp16 K2 and the fp32 K8, K10 and K12
    times, the fp32 K2's and K6's are printed beside those of the loops
    they replaced (REPLACED_WIDE_BWD_MS). Then the bf16, fp16 and fp32 K2
    at K2_WIDE_EDGE_SHAPES (S 1 to 1024, D 130 to 256: in place, or after
    one `padded_copy` in bf16 and fp16), each call run twice and bitwise
    equal, dqkv within WIDE_REL and the bias partials within
    DBIAS_REL_ATOL (in fp32 both within K2_FP32_EDGE_REL).
17c. fp32 at 518 px (after 17b, whose profiler sessions it follows):
    launch/main.py::main on vit_base_patch14_dinov2 with --precision fp32
    at batch 4 for 2 steps and 1 eval batch, under one torch.profiler
    session: the fp32 K4 (csrc/flash_fwd_simt.cu's
    flash_fwd_simt_kernel<64>) 12 times per forward, K5 and K6
    (csrc/flash_bwd_simt.cu's flash_bwd_dkdv_simt_kernel<64, 128, 2> and
    flash_bwd_dq_simt_kernel<64, 128, 2>) 12 times a step each, by the
    wrappers' counts and by the kernels' names, and no other csrc/ kernel.
    Then phase 14's gradient in fp32 against the same JAX fp32 golden,
    within LONG_FP32_GRAD_LIMITS, set from its witness (the same fp32 step
    with the plain versions of K4-K6 on the card), which runs first; each
    K4-K6 call of the kernel step held against its plain version on the
    model's data (DTYPE_REL['float32'], LSE_ATOL).
17d. K4, K5 and K6 on the tensor cores in fp16 and at head dims 129-256
    (csrc/flash_fwd.cu, csrc/flash_bwd.cu), with the counts reset just
    before: K4 and K5 against their plain versions at
    TC_BLOCKED_EDGE_CASES (S 1 to 1370 around the 64-key and 128-row
    tiles, fp16 at D 64, bf16 and fp16 at D 136, 192, 200 and 256 in the
    qkv-view and dense layouts, D 130 after one padded copy; K5 on the
    plain forward's lse and delta), within WIDE_REL, one launch of each a
    case; K6 at TC_K6_EDGE_CASES (the same, and fp16 at D 128), each call
    twice and bitwise equal, within WIDE_REL of the call's largest plain
    gradient; then each timed at TC_BLOCKED_TIMED (fp16 at (32, 1370, 12,
    64), D 256 at B 1 and 32) beside its plain version, SDPA and its
    bound; then, in a process of its own, one call of each new
    instantiation traced alone (torch.profiler) launching its kernel and
    no other of csrc/.
17e. the fp32 K4, K5 and K6 at head dims 129-256 on the wide register
    tiles (csrc/flash_fwd_simt.cu's flash_fwd_wide_simt_kernel, csrc/
    flash_bwd_simt.cu's flash_bwd_dkdv_wide_simt_kernel and
    flash_bwd_dq_wide_simt_kernel), with the counts reset just before: at
    FP32_WIDE_BLOCKED_EDGE_SHAPES (S 1 to 1370 around K4's and K6's
    32-key groups, 64-row query tiles and 128-key score tiles, K5's 32-key
    blocks and K6's 16-key row pieces; D 136, 192, 200 and 256; q, k, v
    views of a qkv buffer, contiguous, and views whose rows start a float
    late; B·H over 65535), each call twice and bitwise equal, no
    copy, o and lse within K2_FP32_EDGE_REL of their plain versions'
    largest magnitudes (lse of max(it, WIDE_M_FLOOR)), dq, dk and dv of
    the call's largest plain gradient; then each timed at
    FP32_WIDE_BLOCKED_TIMED beside its plain version, SDPA (fp32 forward;
    whole fp32 backward), its bound and the loops it replaced
    (REPLACED_WIDE_BLOCKED_MS). Phase 17b's fp32 trace holds their calls
    at D 256 to these kernels alone.
18. gradient, --pallas_mlp on: phase 8 (use_pallas_attn) on the same
    weights with every MLP
    on the fused route, against the same JAX fp32 train golden (the
    function is the same) with phase 8's limits; exactly 12 launches each
    of K1, K2 and K3, and each K3 call held against its plain version on
    the same inputs (the model's own data).
19. train, --pallas_mlp on: launch/main.py::main with the recipe's flags and
    `--pallas_mlp on` at batch 128 for 3 steps and 2 eval batches (12 K3
    launches per step, none in eval), then the step timed on a fixed device
    batch, printed beside phase 9's default step (the A/B).
20. K9 and K10 vs plain: `fused_attention_qkv_cols` forward and backward at
    S <= 1024 (B 64 and 128 at S 197, H 12, D 64; S 1024, a ragged S and
    D 128), o against attn_fwd_reference (K9's plain version is K1's
    without stats) and the qkv gradient against hp_bwd_reference, with
    phase 3's and 7's limits; at B 64 and 128 the median CUDA-event time
    of each kernel, its plain version and SDPA's forward or backward. Then
    the tensor-core K10 (csrc/hp_bwd_tc.cu) alone in bf16 and fp16 at phase
    3's edges (TC_EDGE_SHAPES), dqkv against hp_bwd_reference within
    DQKV_REL_ATOL, each call run twice and bitwise equal, one copy exactly
    where `bwd_kernel_route` says, and no call reaching csrc/hp_bwd.cu.

The op-level fused attention entry points (ops/attention.py::
multi_head_attention(use_pallas=True), ops/flash_attention.py::
fused_attention_qkv), which no model calls:

21. K7, K8, K11 and K12 vs plain: csrc/attn_fwd_tc.cu in K7's cast order
    (K7, K11 in bf16 and fp16, `fused_kernel_route`; the fp32 ones are
    csrc/fused_attn_fwd.cu's, csrc/attn_fwd_simt.cuh's kernel in K7's
    order, built with the others in phase 2, registers and spills logged)
    and csrc/hp_bwd_tc.cu's launches for K8 and K12
    (`bwd_kernel_route`; fp32 csrc/hp_bwd.cu's library: csrc/hp_bwd_simt.cu
    at D <= 128).
    `multi_head_attention(use_pallas=True)` (K7, K8) on separate (B, H, S,
    D) q, k, v and `fused_attention_qkv` (K11, K12) on a (B, S, 3, H, D)
    buffer, forward and backward, at B 64 and 128 (S 197, H 12, D 64) and
    S 1024, a ragged S at D 48 and D 128; then `multi_head_attention` on
    the permuted (B, H, S, D) views of a qkv buffer, read in place. o
    against fused_fwd_reference and the gradients against
    fused_bwd_reference with phase 20's limits. Then the tensor-core K7 and
    K11 alone in bf16 and fp16 at phase 3's edges (TC_EDGE_SHAPES: S 17 to
    1024, D 64 and 128, and the head dims 2 and 6, which take one padded
    copy exactly where the route says), o against fused_fwd_reference
    within O_ATOL, and the tensor-core K8 and K12 there as phase 20 holds
    K10. At B 64 and 128 the median CUDA-event time of each
    kernel, its plain version and SDPA's forward or backward. Both entry
    points at head dims over 128 (WIDE_FUSED_SHAPES: 136, 137, 192, 256
    and 1024, which JAX pads and runs in its kernels) in bf16, fp16 and
    fp32 must take the route `wide_route` names (the wide tensor-core
    tiles up to 256 in bf16 and fp16, a padded copy at 137; the CUDA-core
    K7, K8, K11 and K12 in fp32 and at 1024), one launch each, held
    against their plain versions within phase 23's limits (bf16 O_ATOL,
    DQKV_REL_ATOL), and are timed beside them at D 256. Both entry points at S = 1100 take
    reference_attention, as JAX routes them, and must launch none of the
    twelve kernels.

Compute other than bf16 (every kernel takes bf16, fp16 and fp32, as the
JAX kernels take any float dtype):

22. launch/main.py::main on my_vit_s (6 heads of 64, tanh GELU: the kernel
    route's widths) for 2 steps and 1 eval batch at batch 32: --precision
    fp32 under the default `--pallas_attn auto` (JAX's switch) and with
    `--pallas_attn on` must launch the fp32 K1 and K2 once per block in
    each step (and K1 in eval); with `--pallas_mlp on` also the fp32 K3
    once per block and step; bf16 launches K1 and K2 as fp32 does. Then
    the fp32 my_vit_b gradient on the kernel route against the JAX fp32
    train golden, within FP32_GRAD_LIMITS, set from its witness (the same
    fp32 step with K1's and K2's plain versions on the card), which runs
    first.
23. every kernel's fp32 and fp16 instantiation: the entry points that
    reach a kernel (qkv_proj_attention, mlp_gelu, fused_attention_qkv_cols
    at S 1370 and 197, multi_head_attention(use_pallas=True),
    fused_attention_qkv) driven forward and backward once in each dtype,
    which must launch each kernel once (in fp16 K1-K5 and K7-K12 on the
    tensor cores); then each kernel held against its
    plain version on the card at its main shape and a ragged one, within
    DTYPE_REL of the largest magnitude (FP32_OUT_REL for fp32 outputs,
    LSE_ATOL for lse), and timed at the main shape beside its plain
    version and SDPA in the same dtype (K3 beside the unfused path in that
    dtype). Then the fp32 K2 (csrc/attn_bwd.cu) at its edges
    (K2_FP32_EDGE_SHAPES: S 1 to 1024 around its 64-row tiles, D 32 to
    128, B and H over 65535), each call run twice and bitwise equal,
    within K2_FP32_EDGE_REL; and the fp32 K1 and K9 (attn_fwd_simt_kernel)
    at theirs (K1_FP32_EDGE_SHAPES: S 1 to 1024 around the 64-row tiles
    and 8-key groups, both sides of the score block's limits, D 32 to 256,
    B and H over 65535), K1 run twice and K9 once, all three bitwise
    equal, o within K2_FP32_EDGE_REL of its largest magnitude and the row
    stats within it relative (m past D 128 of max(|m|, 1)); the fp32 K7
    and K11 (the same kernel in K7's order) at theirs (K7_FP32_EDGE_SHAPES,
    the same edges and limits), K7 run twice and K11 once, all three
    bitwise equal, no copy, o within K2_FP32_EDGE_REL, and K7 on
    K7_FP32_VIEW_CASES (D 130 and views two floats late read in place,
    an odd row stride and one float late copied once), with a [time]
    line; and the fp32 K5 and K6 (csrc/flash_bwd_simt.cu) at theirs
    (K5K6_FP32_EDGE_SHAPES: S 1 to 1370 around the 64-row tiles, D 32 to
    128, views of a qkv buffer, contiguous tensors and views whose rows
    start a float late, B·H over 65535), each call run twice and bitwise
    equal, no copy, dq, dk and dv within K2_FP32_EDGE_REL of the call's
    largest gradient; and the fp32 K4 (csrc/flash_fwd_simt.cu) at
    K4_FP32_EDGE_SHAPES (S 1 to 1370 around its 64-key tiles and 128-row
    blocks, D 32 to 128, the same layouts, B·H over 65535), each call run
    twice and bitwise equal, no copy, o and lse within K2_FP32_EDGE_REL of
    their plain versions' largest magnitudes; and the fp32 K8, K10 and K12
    (csrc/hp_bwd_simt.cu) at HP_FP32_EDGE_SHAPES (S 1 to 1024 around the
    64-row tiles, D 32 to 128, and 136 to 256 around the wide tiles'
    32-key blocks; K10 and K12 in place in a qkv buffer, K8 on
    contiguous tensors, on views whose rows are not 16-byte aligned and on
    views of odd row stride, which `_launch_views` copies once; B·H over
    65535), each call run twice and bitwise equal, copies exactly where
    `_stride_array` refuses the views, dq, dk and dv within
    K2_FP32_EDGE_REL of the call's largest gradient. The fp32 K4 and K8,
    K10, K12 times are printed beside those of the kernels they replaced
    (REPLACED_FP32_MS).
24. trainer state: launch/main.py::main on my_vit_b at batch 128 with the
    recipe's flags, 4 steps an epoch and 1 eval batch, in a directory
    under build/ that the phase removes: an uninterrupted 2-epoch run with
    --output_dir, and the same run stopped when epoch 1 starts (after
    epoch 0's checkpoint, as a preemption stops it) and run again, which
    auto-resumes: the final checkpoints must be bitwise equal (or, if the
    uninterrupted run done twice is not, within STATE_WITNESS_FACTOR of
    that witness's difference), and the resumed epoch must launch K1 and
    K2 12 times a step, as phase 9's run does. Then `python -m
    ...launch.main` in a process of its own (a profiler session in this
    one records no kernels after the trainer phases) continues the
    uninterrupted run to a third epoch with --save_ckpt_num 2,
    --enable_tensorboard, --log_dir and --profile_steps 2: epochs 1 and 2
    must be left on disk (the rotation tests/test_torch_checkpoint.py
    holds to the JAX manager), log.txt one line an epoch, an event file
    under the log dir, and the trace (its size printed) must name the K1
    and K2 kernels. --eval with --resume gives the resumed run's top-1;
    2 steps of --kd --teacher_model my_vit_b --teacher_path <phase 4's
    .pth> launch K1 and K2 for the student alone (12 a step); the server
    with --ckpt <checkpoints dir> --use_ema answers one request with the
    top-5 of this process's forward on the restored EMA. Printed with the
    card's name and power limit: one save and one restore of the b128
    recipe state (params, mu, nu, EMA in fp32) and its size on disk, and
    the recipe step's median CUDA-event time in train_one_epoch with
    --output_dir, TensorBoard and the watchdog on against off, in turns
    (off, on, off, on) in this process.
25. bf16_pure: launch/main.py::main on my_vit_b with the recipe's flags and
    --precision bf16_pure for 3 steps and 2 eval batches (K1 and K2 12 a
    step and eval batch, each call's qkv bf16), then the timed step: every
    param and EMA tensor bf16 (AdamW's moments stay fp32), its median
    CUDA-event time and peak memory printed beside phase 9's bf16 step.
26. on-device augmentation (data/device_aug.py) on a b128 batch of 224-px
    8-bit pixels: each of the 15 RandAugment ops forced through the draw
    (apply_augment, magnitude +-AUG_MAG), then the whole pipeline with the
    recipe's --aa and --reprob 0.25, each held against the same function on
    the CPU with the same draws and noise (the first AUG_CPU_IMAGES images:
    every op is per image): the resampling and photometric ops within
    AUG_ATOL, the quantizing ops exactly, the chain within AUG_CHAIN_ATOL
    but for a share of AUG_CHAIN_SHARE one quantization step away. One
    apply_augment runs under torch.cuda.set_sync_debug_mode('error'), so a
    device-to-host read fails the run. Printed with the card's name and
    power limit: each op's and augment_batch's median CUDA-event time.
27. the folder source behind --device_augment: FOLDER_CLASSES x
    FOLDER_PER_CLASS seeded JPEGs of 256-320 px written under build/smoke/
    (removed at the end), then main() on my_vit_b with the recipe's flags,
    --data_set folder and --device_augment for 3 steps and 2 eval batches
    (K1 and K2 as in phase 9), then the recipe step on the folder's first
    batch with and without --device_augment, in turns (FOLDER_AB_ROUNDS
    rounds), median CUDA-event ms and peak memory.
28. the reg4 DINOv2 (vit_base_patch14_reg4_dinov2 at 518 px: 4 register
    tokens after the class token, no_embed_class, S = 1374 on K4-K6): the
    bf16 forward against the JAX fp32 golden and one train-mode forward +
    backward against the train golden (both at full width, depth
    M2_GOLDEN_DEPTH), without and with remat (K4 then twice a block), each
    K4-K6 call of the remat run against its plain version on the model's
    data, and the largest difference of the two gradients; then main() at
    b32 with all 12 blocks without and with --grad_checkpointing (K4 24, K5
    and K6 12 a step under remat), each with its timed step and peak
    memory, printed with the card's name and power limit.
29. SigLIP (vit_base_patch16_siglip_224: no class token, the MAP head on
    the plain attention): the bf16 forward against its depth-4 golden (K1
    a block), the server's 8 requests (no launch; median latency printed
    with the card's name and power limit), main() at b128 with
    --global_pool map and --pallas_attn auto (K1 and K2 12 a step).
30. the other block types through main() at b64 for 3 steps and 2 eval
    batches: vit_base_patch16_18x2_224 (ParallelThings, K1 36 a forward),
    beit3_base_patch16_224 (the scale norm after K1), vit_base_patch16_
    rpn_224 (ResPost, a qkv without bias) and vit_base_patch16_xp_224
    (parallel scaling, RMSNorm, qk_norm: no launch, as JAX's route gives).
31. --scan_blocks on my_vit_b with the recipe's flags on one fixed batch:
    the losses of SCAN_STEPS steps bitwise equal to loop mode's.

The data axis (parallel/, the trainer on W processes):

32. world 1 over NCCL, in this process (RANK=0 WORLD_SIZE=1 and a free
    MASTER_PORT, as torchrun sets them): main() on my_vit_b at b128 with
    the recipe's flags under DDP (--mesh_shape data) and under FSDP2
    (--param_sharding fsdp), each launching K1 and K2 as phase 9's plain
    main() does; then WORLD1_STEPS steps of the plain, DDP and FSDP2
    trainers on one fixed batch: K1 and K2 12 a step in each, the losses
    equal to the plain step's (bitwise, or within WORLD1_LOSS_RTOL; which
    is printed), and each step's median CUDA-event ms and peak memory,
    printed with the card's name and power limit.
33. two ranks on this card over gloo (NCCL refuses two ranks on one
    GPU; gloo runs every collective of DDP and FSDP2 on CUDA tensors,
    tools/probe_gloo_cuda.py): two subprocesses (gloo_rank), b64 each,
    the recipe's my_vit_b step with the kernel route under DDP, then under
    FSDP2, GLOO_STEPS steps on their rows of one b128 batch, against the
    one-process b128 step on that batch in this process: every model
    input and drop-path mask bitwise equal to its rows of the one-process
    step's, the first step's gradients within GLOO_GRAD_REL_L2 (relative
    L2, per tensor), the params after GLOO_STEPS steps within
    GLOO_PARAM_ATOL, and the global losses printed beside the one-process
    ones.

The rest of the input pipeline (data/wds.py, data/tfrecord.py):

34. webdataset shards: WDS_SHARDS even tar shards of WDS_PER_SHARD seeded
    JPEGs of 256-320 px (phase 27's images) written under build/smoke/wds
    (removed at the end); main() on my_vit_b with the recipe's flags and
    --data_set wds on their brace range for 3 steps and 2 eval batches (K1
    and K2 as in phase 9; where native/libvtx_io.so does not load, as on a
    machine without libjpeg, the shards decode through PIL); then one epoch
    of the train set's WdsDataset alone, its images/s on this host printed
    beside phase 9's recipe step images/s, with the card's name and power
    limit; and, where TensorFlow is not installed, --data_set tfrecord
    must raise ImportError naming it.

The model axis (parallel/split.py, the rest of M6):

35. each of TP_RUNS on ranks of this card over gloo (tp_rank, as phase 33
    starts them), against the one-process step on the same global batch
    in this process: (tp) my_vit_b at 224 px with the recipe's flags,
    global b64, --mesh_shape data:1,model:2, two steps: each rank runs K1
    and K2 on its 6 of the 12 heads (the wrappers' calls are kept, and a
    torch.profiler session of the first step names the kernels); (tp_mlp)
    the same with --pallas_mlp on, K3 on each rank's 1,536 hidden
    columns; (tp_fsdp) --mesh_shape data:2,model:2 --param_sharding fsdp
    on 4 ranks, one step; (sp) vit_base_patch14_dinov2 at 518 px, global
    b8, --mesh_shape data:1,model:2 --param_sharding sp, one step, K4-K6 on
    the gathered 1,370 tokens. Each rank's launches equal the one-process
    step's; the global losses (TP_LOSS_RTOL), grad norms
    (TP_GRAD_NORM_RTOL), the first step's gradients (TP_GRAD_REL_L2,
    relative L2 per tensor) and the params after the steps
    (GLOO_PARAM_ATOL) against the one-process step's, each rank's parts
    saved and joined here (gloo's full_tensor of uneven CUDA shards
    segfaulted on torch 2.11); the worst of each printed beside its limit,
    then one more step's wall time in one process and in each rank (gloo
    over host memory on one card: no speed claim), with the card's name
    and power limit. The next run's ranks start while the current run
    steps, so at most two runs' ranks share the card and the host.

ConvNeXt and the optimizers (models/convnext.py, train/optim.py):

36. convnext_tiny through main() with the ConvNeXt paper's per-GPU recipe
    (CONVNEXT_FLAGS: b128 at 224 px, bf16, --update_freq 4, drop path 0.1,
    layer scale 1e-6, EMA, mixup 0.8 / cutmix 1.0, smoothing 0.1) for 8
    micro-steps, which are 2 updates: the loss finite, the optimizer's
    count 2, and none of the twelve kernels launched (its convolutions and
    products are cuDNN's and cuBLAS's; the model has no kernel route);
    then the micro-step timed on one device batch (median CUDA-event ms,
    images/s, peak memory, with the card's name and power limit); its
    bf16 forward on the seeded weights (gammas 1) through a .pth against
    tests/data/torch_port_golden_convnext_tiny.json (LOGIT_ATOL,
    LOGIT_REL_L2); CONVNEXT_REQUESTS requests to a convnext_tiny server;
    one step each of lamb and adahessian (a double backward) on
    convnext_atto at b128.

Every phase counts the launches of all twelve kernels: a run with the
default flags launches none of K3, K7-K12, and no model path launches K7,
K8, K11 or K12.

Every kernel's line in the kernels JSON carries its time, its plain
version's, the yardstick's (library_ms) and bound_ms: the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s and
its products' FLOPs over the 989 TFLOP/s bf16 tensor-core peak (H100 SXM
data sheet), from the timed call's shapes. The kernels JSON has one line
per bf16 kernel and one per fp32 and fp16 instantiation (name
'kernel[dtype]'), whose bound takes the 67 TFLOP/s fp32 CUDA-core peak and
4-byte elements for fp32, 989 TFLOP/s and 2-byte elements for fp16, and
one per instantiation at D 256 ('kernel[dtype,d256]'). K1's and K2's
lines also carry the launches of phases 29-30's, 32's and 34's main()
runs (launches_siglip, launches_block_types, launches_ddp,
launches_fsdp, launches_wds), K4's, K5's and K6's those of
phase 28's (launches_reg4, launches_reg4_remat); K1-K6 those of phase
35's split runs that launch them (launches_tp, launches_tp_mlp,
launches_tp_fsdp, launches_sp). The fp16 K4, K5
and K6 lines and the bf16 and fp16 K4, K5 and K6 lines at D 256 carry
phase 17d's worst edge error (max_rel_err_edges), and those at D 256 its
times at (32, 1370, 12, 256) (suffix _b32).

The last two lines of stdout are the kernels JSON and the result JSON.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "vision_transformers_torch_xla_tpu_torch"

# Tolerances, kernel vs plain (same bf16 inputs, same cast order; only the
# fp32 summation order differs): o is bf16, |o| < 1 here, so a flipped
# rounding of bf16(p) or of o itself moves it by a few bf16 ulps (2^-8 at
# 0.5..1); the fp32 row stats differ by summation order only.
O_ATOL = 2e-2
ST_RTOL = 1e-4
# Model vs golden: the port computes in bf16 (bf16 residual stream and
# bf16 logits, as the JAX model's bf16 policy does); the golden is the JAX
# model in fp32. Logits here have std ~0.55 and |max| ~1.8.
LOGIT_ATOL = 0.1
LOGIT_REL_L2 = 0.05

# K1's shapes on the train path (B, S, H, D): the batch of 64 and the
# recipe's 128, timed; the trainer's eval batch (128 x eval_batch_mult 1.5)
MAIN_SHAPES = ((64, 197, 12, 64), (128, 197, 12, 64))
EVAL_SHAPES = ((192, 197, 12, 64),)
EXTRA_SHAPES = ((1, 197, 12, 64), (2, 17, 12, 64), (1, 512, 4, 64),
                (1, 1024, 2, 128),
                (3, 77, 3, 48))
# The tensor-core K1, K2 and K9 (bf16, fp16) at their edges: S around one
# and two 128-row tiles up to the contract's 1024, at both head dims of the
# kernels (D = 128's scale is not a power of two, so the rounding of q^
# matters), and head dims that TMA cannot read in place, which take one
# padded copy (odd head counts); phases 3 and 7 run them in bf16 and fp16
TC_EDGE_SHAPES = tuple((2, s, 3, d) for s in (17, 64, 65, 197, 256, 257,
                                              1024) for d in (64, 128)) + (
    (2, 33, 3, 2), (2, 40, 1, 6))
EDGE_DTYPES = ("bfloat16", "float16")
N_REQUESTS = 8
# Backward kernel vs plain (same bf16 inputs, same cast order): a flipped
# bf16 rounding of t or of a stored gradient moves dqkv by a few bf16 ulps
# of values up to ~2, so max abs err <= 2e-2 of max |reference|. The fp32
# bias partials sum 197 rows each and a flip moves one term: <= 1e-3 of
# max |reference|.
BWD_MAIN_SHAPES = ((64, 197, 12, 64), (128, 197, 12, 64))
DQKV_REL_ATOL = 2e-2
DBIAS_REL_ATOL = 1e-3
# Gradient vs the JAX fp32 golden, bf16 compute. The same bf16 path run on
# the CPU is off by 4e-4 (loss), 5e-4 (grad norm) and at most 1.6e-3
# (per-parameter grad norm, relative); the limits leave ~10x room for the
# card's other summation orders.
LOSS_ATOL = 0.02
GRAD_NORM_RTOL = 1e-2
PARAM_GRAD_NORM_RTOL = 2e-2
# Train phase: the recipe (scripts/train_vit_b_v4_64.sh, bench.py:110-139)
TRAIN_BATCH = 128
TRAIN_STEPS = 3
EVAL_BATCHES = 2
RECIPE_FLAGS = [
    "--model", "my_vit_b", "--act_layer", "gelu_tanh",
    "--batch_size", str(TRAIN_BATCH), "--data_set", "synthetic",
    "--model_ema", "true", "--epochs", "1",
    "--limit_steps_per_epoch", str(TRAIN_STEPS),
    "--limit_eval_batches", str(EVAL_BATCHES), "--lr", "4e-3",
    "--min_lr", "1e-6", "--warmup_epochs", "20", "--warmup_lr", "1e-6",
    "--weight_decay", "0.05", "--mixup", "0.8", "--cutmix", "1.0",
    "--smoothing", "0.1", "--drop_path", "0.1"]
FIXED_STEPS = 10
WARMUP_STEPS = 3
TIMED_STEPS = 12
# NVIDIA's data sheet, H100 SXM: dense bf16 tensor-core peak, HBM3 rate
H100_BF16_PEAK_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12

# Long-sequence slice (K4-K6): the model, its seeded weights' LayerScale
# gamma (as tools/make_torch_port_golden.py made the golden) and shapes
LONG_MODEL = "vit_base_patch14_dinov2"
LONG_GAMMA = 1.0
LONG_MAIN_SHAPES = ((1, 1370, 12, 64), (32, 1370, 12, 64))   # (B, S, H, D)
# and K1's and K2's main shapes, where K4, K5 and K6 are timed beside them
LONG_EXTRA_SHAPES = ((2, 1025, 12, 64), (1, 2048, 12, 64),
                     (1, 4097, 2, 128), (64, 197, 12, 64),
                     (128, 197, 12, 64))
# K4-K6 at the rest of their contract, (layout, (B, S, H, D)): B·H over
# 65535 (the grid-y limit the kernels no longer have), head dims that pad
# to 64 and 128 in the kernels, and q, k, v (and dO) that take one copy
# (an odd head dim; a transposed layout, head dim not contiguous)
BLOCKED_EXTRA_CASES = (("qkv", (5462, 40, 12, 64)), ("qkv", (3, 77, 3, 48)),
                       ("qkv", (2, 300, 2, 96)), ("dense", (2, 200, 2, 47)),
                       ("transposed", (2, 260, 4, 64)))
# Blocked kernels vs plain (same bf16 inputs, same cast order): o is bf16
# and each bf16(p) is rounded against the tile's running max in the kernel
# and against the row's max in the plain version, so o moves by a flipped
# rounding of o itself, up to 2^-7 of max |o| per ulp: the limit is
# O_REL_ATOL of the plain version's max |o| (~2.5 ulps there). At S = 1370
# |o| is small (~0.25 at its max), so an absolute limit would be loose.
# lse is fp32 (summation order only); the stored bf16 grads move by a few
# ulps of their largest value (DQKV_REL_ATOL).
O_REL_ATOL = 2e-2
LSE_ATOL = 1e-4
LONG_BATCH = 32
LONG_TRAIN_FLAGS = [
    "--model", LONG_MODEL, "--input_size", "518", "--global_pool", "token",
    "--batch_size", str(LONG_BATCH), "--data_set", "synthetic",
    "--model_ema", "true", "--epochs", "1",
    "--limit_steps_per_epoch", str(TRAIN_STEPS),
    "--limit_eval_batches", str(EVAL_BATCHES), "--lr", "4e-3",
    "--min_lr", "1e-6", "--warmup_epochs", "20", "--warmup_lr", "1e-6",
    "--weight_decay", "0.05", "--mixup", "0.8", "--cutmix", "1.0",
    "--smoothing", "0.1", "--drop_path", "0.1"]
# Phase 14, the 518-px gradient against the JAX fp32 train golden: limits
# (loss abs, grad norm rel, per-parameter grad norm rel). The witness, the
# same bf16 step with the plain versions of K4-K6 on the card, read 4.9e-3,
# 8.3e-4 and 2.3e-3 (H100 80GB HBM3, 700 W); the limits leave ~10x room.
# Two correct bf16 steps differ this much: kernels and witness differ by
# 7.4e-3 in the loss. A kernel fault is caught by the per-call checks of
# K4-K6 against their plain versions on the model's data in the same phase.
LONG_GRAD_LIMITS = (0.05, 1e-2, 2.5e-2)
LONG_WARMUP_STEPS = 2
LONG_TIMED_STEPS = 5
# Phase 17c, the 518-px trainer in fp32 (the fp32 K4 of
# csrc/flash_fwd_simt.cu, K5 and K6 of csrc/flash_bwd_simt.cu): main() at
# a small batch for
# LONG_FP32_STEPS steps and LONG_FP32_EVALS eval batch, under one
# torch.profiler session that names the kernels it launched
LONG_FP32_BATCH, LONG_FP32_STEPS, LONG_FP32_EVALS = 4, 2, 1
LONG_FP32_FLAGS = [
    "--model", LONG_MODEL, "--input_size", "518", "--global_pool", "token",
    "--precision", "fp32", "--batch_size", str(LONG_FP32_BATCH),
    "--data_set", "synthetic", "--epochs", "1", "--limit_steps_per_epoch",
    str(LONG_FP32_STEPS), "--limit_eval_batches", str(LONG_FP32_EVALS),
    "--warmup_epochs", "0"]
# a csrc/ kernel's demangled name (every source keeps its kernels in an
# anonymous namespace, under these stems)
CSRC_KERNEL = r"void \(anonymous namespace\)::(attn|flash|fc2|hp|fused)_"
LONG_FP32_KERNELS = {
    "flash_fwd_simt_kernel<64>": "FLASH_FWD_LAUNCHES",
    "flash_bwd_dkdv_simt_kernel<64, 128, 2>": "FLASH_BWD_DKDV_LAUNCHES",
    "flash_bwd_dq_simt_kernel<64, 128, 2>": "FLASH_BWD_DQ_LAUNCHES"}
# and its fp32 gradient on the kernel route against the JAX fp32 train
# golden: limits (loss abs, grad norm rel, per-parameter grad norm rel),
# 10x the witness's errors rounded down (the same fp32 step with the plain
# versions of K4-K6 on the card read a loss equal to the golden's to the
# bit, 1.54e-7 and 3.89e-7; H100 80GB HBM3, 700 W), the loss's from one
# fp32 ulp of it (4.77e-7 at 7.35). Both sides are fp32 and differ in
# summation order only.
LONG_FP32_GRAD_LIMITS = (4.7e-6, 1.5e-6, 3.8e-6)

# The fused-backward MLP (K3): (B, S, O, K) shapes of fc2_bwd. Kernel vs
# plain (same bf16 inputs, same cast order): dh and a are bf16 and move by
# a flipped rounding (the fp32 summation order of da), a few bf16 ulps of
# their largest value; db1 sums fp32 dh, so only the summation order moves
# it.
MLP_MAIN_SHAPES = ((128, 197, 768, 3072), (64, 197, 768, 3072))
MLP_EXTRA_SHAPES = ((3, 77, 768, 3072), (2, 130, 128, 256), (1, 5, 256, 512))
DH_REL_ATOL = 2e-2
DB1_REL_ATOL = 1e-3
PALLAS_MLP_FLAGS = RECIPE_FLAGS + ["--pallas_mlp", "on"]
# Phase 22: the trainer in fp32 and in bf16 on a small ViT of the kernel
# route's widths (tanh GELU, so that --pallas_mlp on fuses every MLP)
PRECISION_FLAGS = [
    "--model", "my_vit_s", "--act_layer", "gelu_tanh", "--batch_size", "32",
    "--data_set", "synthetic", "--epochs", "1", "--limit_steps_per_epoch",
    "2", "--limit_eval_batches", "1", "--warmup_epochs", "0"]
PRECISION_STEPS, PRECISION_EVALS, PRECISION_DEPTH = 2, 1, 12
PRECISION_RUNS = {"fp32": ["--precision", "fp32"],
                  "fp32_on": ["--precision", "fp32", "--pallas_attn", "on"],
                  "fp32_mlp": ["--precision", "fp32", "--pallas_mlp", "on"],
                  "bf16": ["--precision", "bf16"]}
# Phase 22, the fp32 my_vit_b gradient on the kernel route (K1, K2 in fp32)
# against the JAX fp32 train golden: limits (loss abs, grad norm rel,
# per-parameter grad norm rel), 10x the witness's errors rounded down (the
# same fp32 step with the plain versions on the card read 9.54e-7, 6.48e-9
# and 1.98e-7; H100 80GB HBM3, 700 W). Both sides are fp32 and differ in
# summation order only.
FP32_GRAD_LIMITS = (9.5e-6, 6.4e-8, 1.9e-6)
# Phase 23, every kernel in fp32 and fp16 (the JAX kernels take any float
# dtype), kernel vs plain on the same inputs: fp32 differs by summation
# order and expf only, so o, the grads, dh and a are held to DTYPE_REL
# ['float32'] of the plain version's largest magnitude; fp16 moves by
# flipped fp16 roundings (2^-11 relative per ulp) of p, ds and the stored
# values: DTYPE_REL['float16']. The fp32 outputs (row stats, bias
# partials) to FP32_OUT_REL of their largest magnitude, lse to LSE_ATOL.
DTYPES = ("float32", "float16")
DTYPE_REL = {"float32": 1e-4, "float16": 5e-3}
FP32_OUT_REL = {"float32": 1e-4, "float16": 1e-3, "bfloat16": 1e-3}
# each kernel's (main shape, ragged shape): (B, S, H, D), K3's (B, S, O, K);
# the main shapes are the bf16 lines' own
_ATTN_197 = ((128, 197, 12, 64), (3, 77, 3, 48))
_LONG = ((32, 1370, 12, 64), (2, 1100, 3, 48))
DTYPE_SHAPES = {
    "attn_fwd": _ATTN_197, "attn_bwd": _ATTN_197,
    "flash_fwd": _LONG, "flash_bwd_dkdv": _LONG, "flash_bwd_dq": _LONG,
    "fc2_bwd": ((128, 197, 768, 3072), (3, 77, 768, 3072)),
    "hp_fwd": _ATTN_197, "hp_bwd": _ATTN_197,
    "fused_fwd": ((128, 197, 12, 64), (3, 130, 3, 48)),
    "fused_bwd": ((128, 197, 12, 64), (3, 130, 3, 48)),
    "qkv_fwd": ((128, 197, 12, 64), (3, 130, 3, 48)),
    "qkv_bwd": ((128, 197, 12, 64), (3, 130, 3, 48))}
# the bound of each dtype's work: fp32 has no tensor-core product, so its
# peak is the CUDA cores' 67 TFLOP/s (H100 SXM data sheet), fp16 the
# 989 TFLOP/s tensor-core peak of bf16; element bytes 4 and 2
DTYPE_PEAK = {"float32": (67e12, 4), "float16": (989e12, 2),
              "bfloat16": (989e12, 2)}
# The fp32 K2 (csrc/attn_bwd.cu) at its edges, (B, S, H, D): S around its
# 64-row tiles up to the contract's 1024, D 32, 48, 64 and 128, and B and
# H over 65535 at a tiny S. Kernel vs plain in fp32 differ by summation
# order and expf only: dqkv and the bias partials within
# K2_FP32_EDGE_REL of the plain version's largest magnitude (the kernel's
# earlier design read 4.3e-6 absolute at its main shape, gradients up to
# ~2.7).
K2_FP32_EDGE_SHAPES = ((2, 1, 3, 32), (2, 63, 3, 64), (2, 64, 3, 64),
                       (2, 65, 3, 64), (2, 197, 3, 48), (2, 197, 3, 128),
                       (1, 1024, 2, 128), (1, 8, 65537, 8),
                       (65537, 8, 1, 8))
K2_FP32_EDGE_REL = 1e-5
# The fp32 K5 and K6 (csrc/flash_bwd_simt.cu) at their edges, (layout, (B,
# S, H, D)): S around the 64-row tiles up to the 518-px model's 1370, D 32,
# 48, 64, 96 and 128 (64 and 128 compiled, the others zero-filled), views
# of a qkv buffer and contiguous tensors (16-byte copies), views of a
# buffer whose rows start one float late (4-byte copies), and B·H over
# 65535 at a short S; held to K2_FP32_EDGE_REL of the call's largest
# gradient (at S = 1, dq and dk are 0 but for rounding: o = v)
K5K6_FP32_EDGE_SHAPES = tuple(
    (layout, (1, s, 2, d)) for layout in ("qkv", "dense")
    for s in (1, 63, 64, 65, 127, 1025, 1370) for d in (32, 48, 64, 96, 128)
) + tuple(("unaligned", (1, s, 2, d)) for s in (65, 1370) for d in (48, 64)
          ) + (("qkv", (1, 8, 65537, 8)), ("dense", (65537, 8, 1, 8)))
# The fp32 K4 (csrc/flash_fwd_simt.cu) at its edges, (layout, (B, S, H,
# D)): S around its 64-key tiles and 128-row blocks up to the 518-px
# model's 1370, K5K6's head dims and layouts, and B·H over 65535; o and
# lse held to K2_FP32_EDGE_REL of their plain versions' largest magnitudes
K4_FP32_EDGE_SHAPES = tuple(
    (layout, (1, s, 2, d)) for layout in ("qkv", "dense")
    for s in (1, 63, 64, 65, 127, 128, 129, 197, 1025, 1370)
    for d in (32, 48, 64, 96, 128)
) + tuple(("unaligned", (1, s, 2, d)) for s in (65, 1370) for d in (48, 64)
          ) + (("qkv", (1, 8, 65537, 8)), ("dense", (65537, 8, 1, 8)))
# The fp32 K8, K10 and K12 (csrc/hp_bwd_simt.cu) at their edges, (kernel,
# layout, (B, S, H, D)): S around the 64-row tiles and 128-row blocks up to
# the kernels' 1024, D 32 to 128, and past 128 the wide tiles' (32-key
# blocks, 64-query tiles) at D 136, 192 and 256; K10 and K12 in place in a
# qkv buffer, K8
# on contiguous tensors, on views whose rows start two floats late (the
# kernels' 4-byte copies) and on views of odd row stride (one copy by
# `_launch_views`), and B·H over 65535; held to K2_FP32_EDGE_REL of the
# call's largest gradient (at S = 1, dq and dk are 0 but for rounding)
HP_FP32_EDGE_SHAPES = tuple(
    (kernel, layout, (1, s, 2, d))
    for kernel, layout in (("hp_bwd", "qkv"), ("qkv_bwd", "qkv"),
                           ("fused_bwd", "dense"))
    for s in (1, 63, 64, 65, 127, 128, 129, 197, 1024)
    for d in (32, 48, 64, 96, 128)
) + tuple(("fused_bwd", layout, (2, s, 3, d))
          for layout in ("late", "odd_stride") for s in (65, 197)
          for d in (48, 64)) + (("hp_bwd", "qkv", (1, 8, 65537, 8)),
                                ("fused_bwd", "dense", (65537, 8, 1, 8))
                                ) + tuple(
    (kernel, layout, (1, s, 2, d))
    for kernel, layout in (("hp_bwd", "qkv"), ("qkv_bwd", "qkv"),
                           ("fused_bwd", "dense"))
    for s in (1, 31, 32, 33, 65, 197, 1024) for d in (136, 192, 256))
# The fp32 times of the kernels that flash_fwd_simt.cu, hp_bwd_simt.cu and
# attn_fwd_simt.cuh replaced (flash_blocked.cu's flash_fwd_kernel<float,
# 64>, hp_bwd.cu's loops at D 64, fused_attn_fwd.cu's fused_attn_fwd_kernel<
# float, 64>), device ms of one call at the main shapes, from the timing
# tool in the same call as the new kernels (PERF.md §6; H100 80GB HBM3 at
# 700 W), printed beside phase 23's new (event) ones
REPLACED_FP32_MS = {"flash_fwd": "7.193-7.203", "fused_bwd": "5.53-5.55",
                    "hp_bwd": "5.50", "qkv_bwd": "5.50-5.51",
                    "fused_fwd": "1.4246-1.4259",
                    "qkv_fwd": "1.4246-1.4253"}
# and of the fp32 K1, K9 (attn_fwd.cu's attn_fwd_kernel<float, 0>), K7 and
# K11 (fused_attn_fwd_kernel<float, 0>) that attn_fwd_simt.cuh replaced at
# WIDE_TIMED, printed beside phase 17b's
REPLACED_WIDE_FP32_MS = {"attn_fwd": "9.578", "hp_fwd": "9.552-9.564",
                         "fused_fwd": "10.453-10.555",
                         "qkv_fwd": "10.397-10.561"}
# and of the loops that the wide tiles of csrc/attn_bwd_tc.cu (K2 in bf16
# and fp16), csrc/attn_bwd_simt.cu (the fp32 K2) and csrc/hp_bwd_simt.cu
# (the fp32 K8, K10 and K12) replaced at WIDE_TIMED, and csrc/flash_bwd.cu's
# (K6 in bf16 and fp16) and csrc/flash_bwd_simt.cu's (the fp32 K6) at
# WIDE_LONG_TIMED: csrc/attn_bwd.cu's
# attn_bwd_wide_kernel, csrc/hp_bwd.cu's run-time head dim and
# csrc/flash_blocked.cu's flash_bwd_dq_wide_kernel, event ms of phase 17b
# (PERF.md §6), printed beside phase 17b's
REPLACED_WIDE_BWD_MS = {("bfloat16", "attn_bwd"): "9.580",
                        ("float16", "attn_bwd"): "9.760",
                        ("float32", "attn_bwd"): "10.710",
                        ("bfloat16", "flash_bwd_dq"): "2.091",
                        ("float16", "flash_bwd_dq"): "2.166",
                        ("float32", "flash_bwd_dq"): "2.125",
                        ("float32", "fused_bwd"): "36.913",
                        ("float32", "hp_bwd"): "36.674",
                        ("float32", "qkv_bwd"): "36.875"}
# K2 on the wide tensor-core tiles (csrc/attn_bwd_tc.cu, bf16 and fp16) and
# the fp32 register tiles (csrc/attn_bwd_simt.cu: 32-key blocks, 64-query
# tiles) at their edges, (B, S, H, D): S around the 32-query streamed and
# 64-row stationary tiles up to the kernels' 1024; D 136, 192, 200 and 256
# read in place (136 and 200 zero-filled to the next compiled tile), 130
# after one `padded_copy` (in fp32 in place); each call twice and bitwise
# equal, dqkv within WIDE_REL and the bias partials within DBIAS_REL_ATOL
# of their largest magnitude (fp32: both within K2_FP32_EDGE_REL)
K2_WIDE_EDGE_SHAPES = tuple(
    (1, s, 2, d) for s in (1, 63, 64, 65, 127, 128, 129, 197, 1024)
    for d in (136, 192, 200, 256)) + tuple((1, s, 2, 130) for s in (65, 197))
# The fp32 K1 and K9 (csrc/attn_fwd_simt.cuh, attn_fwd_simt_kernel in K1's
# order) at their edges, (B, S, H, D): S around the 64-row query and key
# tiles, the 8-key groups (32-key groups and the 256-key score tile past D
# 128) up to 1024, the score block's limits (S 496 / 497 at D 128, 688 /
# 689 at D 64, 784 / 785 at D 32, 448 / 449 at D 136 and 192, 384 / 385 at
# D 256: past them s is recomputed), D 32, 48, 64, 128, 136, 192 and 256,
# and B and H over 65535; held to K2_FP32_EDGE_REL as K2 (fp32 summation
# order and expf only)
FP32_FWD_EDGE_S = (1, 63, 64, 65, 513, 1024)
FP32_FWD_EDGE_D = (32, 48, 64, 128, 136, 192, 256)
FP32_FWD_LIMITS = ((496, 128), (497, 128), (688, 64), (689, 64), (784, 32),
                   (785, 32), (448, 192), (449, 192), (448, 136),
                   (449, 136), (384, 256), (385, 256))
K1_FP32_EDGE_SHAPES = tuple((2, s, 2, d) for s in FP32_FWD_EDGE_S
                            for d in FP32_FWD_EDGE_D) + tuple(
    (2, s, 2, d) for s, d in FP32_FWD_LIMITS) + (
    (1, 8, 65537, 8), (65537, 8, 1, 8))
# past D 128 a row max m sums up to 256 products, whose rounding does not
# shrink with |m|: there m is held within K2_FP32_EDGE_REL of max(|m|, 1)
WIDE_M_FLOOR = 1.0
# The fp32 K7 and K11 (the same kernel in K7's order) at the same edges and
# limits, (B, S, H, D), and on views (layout, (B, S, H, D)) that the kernel
# reads in place with 8-byte copies (D 130; q, k, v two floats late) or
# that _launch_views copies once (an odd row stride, one float late)
K7_FP32_EDGE_SHAPES = tuple((2, s, 2, d) for s in FP32_FWD_EDGE_S + (197,)
                            for d in FP32_FWD_EDGE_D) + tuple(
    (2, s, 2, d) for s, d in FP32_FWD_LIMITS)
K7_FP32_VIEW_CASES = (("dense", (2, 197, 2, 130)),
                      ("pair_offset", (2, 197, 2, 256)),
                      ("odd_row_stride", (2, 197, 2, 256)),
                      ("odd_offset", (2, 197, 2, 192)))
# check_redesigned traces the fp32 K1, K9, K7 and K11 at these head dims
REDESIGNED_FWD_D = (64, 136, 192, 256)
# The head-pair route (K9, K10) of fused_attention_qkv_cols, (B, S, H, D)
HP_MAIN_SHAPES = ((64, 197, 12, 64), (128, 197, 12, 64))
HP_EXTRA_SHAPES = ((1, 1024, 2, 64), (3, 77, 3, 48), (2, 130, 2, 128))
# The op-level fused route (K7, K8, K11, K12), (B, S, H, D); the view case
# runs multi_head_attention on the permuted views of a qkv buffer
FUSED_MAIN_SHAPES = ((64, 197, 12, 64), (128, 197, 12, 64))
FUSED_EXTRA_SHAPES = ((1, 1024, 2, 64), (3, 130, 3, 48), (2, 77, 2, 128))
FUSED_VIEW_SHAPE = (8, 197, 12, 64)
# past the kernels' S: reference_attention, as JAX routes it
REFERENCE_FUSED_SHAPES = ((1, 1100, 2, 64),)
# head dims over the narrow tiles' 128: K7, K8, K11, K12 on the wide
# tensor-core tiles up to 256 in bf16 and fp16, on the CUDA cores in fp32
# and at 1024 (the first is timed)
WIDE_FUSED_SHAPES = ((2, 197, 4, 256), (2, 197, 2, 136), (1, 77, 2, 192),
                     (1, 65, 3, 137), (1, 64, 1, 1024))
WIDE_REL = {"bfloat16": DQKV_REL_ATOL, "float16": 5e-3, "float32": 1e-4}
# The wide-head phase (F8 closed on every route), (B, S, H, D):
# qkv_proj_attention (K1, K2) and fused_attention_qkv_cols at S <= 1024
# (K9, K10) at WIDE_QKV_SHAPES, fused_attention_qkv_cols at S > 1024 (K4-K6)
# at WIDE_LONG_SHAPES, multi_head_attention(use_pallas=True) and
# fused_attention_qkv (K7, K8, K11, K12) at WIDE_QKV_SHAPES[0], in bf16,
# fp16 and fp32: the wide tensor-core tiles at 129-256 in bf16 and fp16,
# the CUDA cores in fp32, past 256 and for K6 past 128. Each
# kernel is held against its plain version within WIDE_REL of the largest
# magnitude (FP32_OUT_REL for fp32 outputs, LSE_ATOL for lse) and timed at
# WIDE_TIMED beside its plain version and SDPA (K4-K6 at WIDE_LONG_TIMED).
WIDE_QKV_SHAPES = ((2, 197, 4, 256), (2, 197, 2, 192), (1, 77, 2, 136),
                   (1, 65, 2, 320), (1, 64, 1, 1024))
WIDE_LONG_SHAPES = ((1, 1100, 2, 256), (1, 1100, 2, 192), (1, 1100, 1, 320),
                    (1, 1025, 1, 1024))
WIDE_TIMED = (32, 197, 12, 256)
WIDE_LONG_TIMED = (1, 1370, 4, 256)
WIDE_DTYPES = ("bfloat16", "float16", "float32")
# Phase 17d, K4, K5 and K6 on the tensor cores in fp16 and at head dims
# 129-256 (csrc/flash_fwd.cu, csrc/flash_bwd.cu): K4's and K5's against their
# plain version at the blocked kernels' edge sequences (around the 64-key
# and 128-row tiles, past 1024, the 518-px model's 1370) in the qkv-view
# and dense layouts, (dtype, layout, (B, S, H, D)): fp16 at D 64, bf16 and
# fp16 at 136 and 200 (the 192 and 256 tiles with zero-filled columns),
# 192 and 256, and D 130 (one padded copy); within WIDE_REL of the largest
# magnitude (of o; of the call's dk and dv together), lse within LSE_ATOL
TC_BLOCKED_EDGE_S = (1, 63, 64, 65, 127, 129, 1025, 1370)
TC_BLOCKED_EDGE_CASES = tuple(
    (dt, layout, (1, s, 2, d)) for dt in EDGE_DTYPES
    for layout in ("qkv", "dense") for s in TC_BLOCKED_EDGE_S
    for d in ((64,) if dt == "float16" else ()) + (136, 192, 200, 256)
) + tuple((dt, "qkv", (1, s, 2, 130)) for dt in EDGE_DTYPES
          for s in (65, 1370))
# and K6's (csrc/flash_bwd.cu: fp16 at D 64 and 128, the wide tiles past
# 128), each call twice and bitwise equal, dq within WIDE_REL of the call's
# largest plain gradient (dq, dk, dv: at S = 1 ds is rounding noise)
TC_K6_EDGE_CASES = tuple(
    (dt, layout, (1, s, 2, d)) for dt in EDGE_DTYPES
    for layout in ("qkv", "dense") for s in TC_BLOCKED_EDGE_S
    for d in ((64, 128) if dt == "float16" else ()) + (136, 192, 200, 256)
) + tuple((dt, "qkv", (1, s, 2, 130)) for dt in EDGE_DTYPES
          for s in (65, 1370))
# and each timed beside its plain version and SDPA, at the 518-px shape in
# fp16 and at D 256 at B 1 (phase 17b's wide shape) and B 32 (~270 MB an
# operand), (dtype, (B, S, H, D)); the plain versions take
# TC_BLOCKED_SLOW_REPS timed calls (the CUDA-core loops the new kernels
# replaced are gone from the tree; their times, in one call with the new
# kernels, stand in PERF.md §6)
TC_BLOCKED_TIMED = (("float16", (32, 1370, 12, 64)),
                    ("bfloat16", WIDE_LONG_TIMED),
                    ("float16", WIDE_LONG_TIMED),
                    ("bfloat16", (32, 1370, 12, 256)),
                    ("float16", (32, 1370, 12, 256)))
TC_BLOCKED_SLOW_REPS = 8
# the instantiations phase 17d traces one call of each, in a process of
# its own: (dtype, head dim); K6 at TC_BLOCKED_K6_TRACED (its new
# instantiations and the bf16 one at 64 that it had)
TC_BLOCKED_TRACED = (("float16", 64), ("float16", 128), ("bfloat16", 192),
                     ("float16", 192), ("bfloat16", 256), ("float16", 256))
TC_BLOCKED_K6_TRACED = TC_BLOCKED_TRACED + (("bfloat16", 64),)
# Phase 17e, the fp32 K4, K5 and K6 at head dims 129-256 on the wide
# register tiles (csrc/flash_fwd_simt.cu, csrc/flash_bwd_simt.cu) at their
# edges, (layout, (B, S, H, D)): S around K4's 32-key groups, 64-row query
# tiles and 128-key score tiles (K6's too), K5's 32-key blocks and K6's
# 16-key row pieces up to the 518-px model's 1370; D 136 and 200 (the
# 192 and 256 tiles with zero-filled columns), 192 and 256; views of a qkv
# buffer and contiguous tensors (16-byte copies), views whose rows start
# one float late (4-byte copies); B·H over 65535 at a short S. Held to
# K2_FP32_EDGE_REL as K4-K6 at D <= 128 (lse of max(its largest,
# WIDE_M_FLOOR): at S = 1 it is one score)
FP32_WIDE_BLOCKED_EDGE_SHAPES = tuple(
    (layout, (1, s, 2, d)) for layout in ("qkv", "dense", "unaligned")
    for s in (1, 17, 31, 32, 33, 63, 65, 127, 128, 129, 1025, 1370)
    for d in (136, 192, 200, 256)) + (("qkv", (1, 8, 65537, 136)),
                                      ("dense", (65537, 8, 1, 136)))
# and timed at these shapes beside their plain versions, SDPA and the
# times, at the first, of the csrc/flash_blocked.cu loops they replaced
# (flash_fwd_wide_kernel<float>, flash_bwd_dkdv_wide_kernel<float>,
# flash_bwd_dq_wide_kernel<float>; device ms of the timing tool's A/Bs,
# PERF.md §6, H100 80GB HBM3 at 700 W)
FP32_WIDE_BLOCKED_TIMED = ((32, 1370, 12, 256),)
REPLACED_WIDE_BLOCKED_MS = {"flash_fwd": "86.08-86.17",
                            "flash_bwd_dkdv": "249.69-250.01",
                            "flash_bwd_dq": "155.00-155.01"}
WIDE_KERNELS = ("attn_fwd", "attn_bwd", "hp_fwd", "hp_bwd", "fused_fwd",
                "fused_bwd", "qkv_fwd", "qkv_bwd", "flash_fwd",
                "flash_bwd_dkdv", "flash_bwd_dq")

# Phase 24, the trainer's state: the recipe at b128 for STATE_STEPS steps
# an epoch and STATE_EVALS eval batches; a resumed run that is not
# bitwise equal to the uninterrupted one must differ by at most this
# factor times the uninterrupted run's difference from itself (the
# witness); the sinks' A/B times STATE_AB_STEPS steps a turn after
# STATE_AB_WARMUP
STATE_STEPS, STATE_EVALS, STATE_EPOCHS = 4, 1, 2
STATE_WITNESS_FACTOR = 4.0
STATE_KD_STEPS = 2
STATE_AB_STEPS, STATE_AB_WARMUP = 15, 3
STATE_TIMEOUT_S = 300
# profiler sessions a trace may take, when a session records no device
# event, or (only_kernels) misses a kernel it wants and records no other
TRACE_TRIES = 4
# Phase 25: --precision bf16_pure on the recipe (params, grads, EMA bf16)
BF16_PURE_FLAGS = RECIPE_FLAGS + ["--precision", "bf16_pure"]
# Phase 26: the on-device augmentation (data/device_aug.py) on a b128
# 224-px batch of 8-bit pixels, with the recipe's --aa and --reprob 0.25;
# each RandAugment op forced through the draw at AUG_MAG, and the card held
# against the CPU on the first AUG_CPU_IMAGES images (every op is per image,
# its parameters shared by the batch). The same fp32 ops on both: the
# resampling and photometric ops to AUG_ATOL, the quantizing ops exactly;
# the chained augment_batch resamples before it quantizes, so an element
# whose input moved by an ulp may land one quantization step away (at most
# 1 in pixel units): all within AUG_CHAIN_ATOL but a share of at most
# AUG_CHAIN_SHARE (tests/test_torch_device_aug.py's limits)
AUG_BATCH = TRAIN_BATCH
AUG_FLAGS = ["--device_augment", "true", "--aa", "rand-m9-mstd0.5-inc1",
             "--reprob", "0.25"]
AUG_MAG = 0.7
AUG_CPU_IMAGES = 32
AUG_ATOL = 1e-5
AUG_CHAIN_ATOL, AUG_CHAIN_SHARE = 5e-5, 1e-3
AUG_QUANTIZING = ("Posterize", "Solarize", "SolarizeAdd", "Equalize",
                  "Invert")
# Phase 27: --device_augment on a folder of JPEGs that the phase writes
# (FOLDER_CLASSES x FOLDER_PER_CLASS, 256-320 px): 4 steps of b128 an epoch
FOLDER_CLASSES, FOLDER_PER_CLASS = 4, 128
FOLDER_AB_ROUNDS = 2
# Phase 34: even webdataset shards, 3 steps of b128 and 2 eval batches of
# b192 an epoch (the shards' count, extrapolated from the first, is 384)
WDS_SHARDS, WDS_PER_SHARD = 4, 96
# Phases 28-31, the rest of the ViT. Phase 28: the reg4 DINOv2 at 518 px
# (4 register tokens, no_embed_class: S = 1374 on K4-K6); its goldens
# (tests/data/, made by tools/make_torch_port_golden.py and
# make_torch_port_train_golden.py) are at full width and depth
# M2_GOLDEN_DEPTH, the trainer runs all 12 blocks at b32, with and
# without --grad_checkpointing (K4 twice a block and step under remat)
REG4_MODEL = "vit_base_patch14_reg4_dinov2"
M2_GOLDEN_DEPTH = 4
REG4_FLAGS = [REG4_MODEL if f == LONG_MODEL else f for f in LONG_TRAIN_FLAGS]
# Phase 29: SigLIP (no class token, the MAP head on the plain attention,
# K1/K2 in the 12 blocks at S 196): the forward against its depth-4
# golden, the server's requests, main() at b128
SIGLIP_MODEL = "vit_base_patch16_siglip_224"
SIGLIP_FLAGS = ["--model", SIGLIP_MODEL, "--global_pool", "map",
                "--pallas_attn", "auto"] + RECIPE_FLAGS[4:]
M2_WARMUP_STEPS, M2_TIMED_STEPS = 2, 5
# Phase 30: the other block types through main() at b64: K1 (and K2 in a
# step) a forward: ParallelThings 2 a block, beit3's scale norms and rpn's
# ResPost (no qkv bias) 1, xp's parallel scaling none (plain attention, as
# JAX's route gives)
BLOCK_TYPE_RUNS = {"vit_base_patch16_18x2_224": 36,
                   "beit3_base_patch16_224": 12,
                   "vit_base_patch16_rpn_224": 12,
                   "vit_base_patch16_xp_224": 0}
BLOCK_TYPE_BATCH = 64
# Phase 31: --scan_blocks on the recipe's fixed batch: SCAN_STEPS losses
# bitwise equal to loop mode's
SCAN_STEPS = 4

# every kernel's launch count, 'module.COUNT' in ops/
ALL_COUNTS = ("flash_attention.ATTN_FWD_LAUNCHES",
              "flash_attention.ATTN_BWD_LAUNCHES",
              "flash_blocked.FLASH_FWD_LAUNCHES",
              "flash_blocked.FLASH_BWD_DKDV_LAUNCHES",
              "flash_blocked.FLASH_BWD_DQ_LAUNCHES",
              "mlp_fused.FC2_BWD_LAUNCHES",
              "flash_attention.HP_FWD_LAUNCHES",
              "flash_attention.HP_BWD_LAUNCHES",
              "flash_attention.FUSED_FWD_LAUNCHES",
              "flash_attention.FUSED_BWD_LAUNCHES",
              "flash_attention.QKV_FWD_LAUNCHES",
              "flash_attention.QKV_BWD_LAUNCHES")


# ConvNeXt (phase 36): the ConvNeXt paper's per-GPU recipe (Liu et al.
# 2022, App. A.1: 128 images a GPU, update_freq 4, AdamW at lr 4e-3,
# warmup 20 epochs, wd 0.05, layer scale 1e-6, drop path 0.1, EMA,
# mixup 0.8 / cutmix 1.0, smoothing 0.1) on convnext_tiny at 224 px in the
# bf16 policy: CONVNEXT_MICRO_STEPS micro-steps are 2 updates
CONVNEXT_MODEL = "convnext_tiny"
CONVNEXT_UPDATE_FREQ = 4
CONVNEXT_MICRO_STEPS = 8
CONVNEXT_FLAGS = [
    "--model", CONVNEXT_MODEL, "--batch_size", str(TRAIN_BATCH),
    "--input_size", "224", "--data_set", "synthetic", "--precision", "bf16",
    "--update_freq", str(CONVNEXT_UPDATE_FREQ), "--epochs", "1",
    "--limit_steps_per_epoch", str(CONVNEXT_MICRO_STEPS),
    "--limit_eval_batches", "1", "--lr", "4e-3", "--min_lr", "1e-6",
    "--warmup_epochs", "20", "--warmup_lr", "1e-6", "--weight_decay",
    "0.05", "--layer_scale_init_value", "1e-6", "--drop_path", "0.1",
    "--model_ema", "true", "--mixup", "0.8", "--cutmix", "1.0",
    "--smoothing", "0.1"]
CONVNEXT_REQUESTS = 3
# one step of each on the smallest ConvNeXt at the recipe's batch
CONVNEXT_OPT_MODEL = "convnext_atto"
CONVNEXT_OPTS = ("lamb", "adahessian")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, in ms (host launch cost included)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float = H100_BF16_PEAK_FLOPS):
    """Least time on an H100 SXM for this work, in ms, and what bounds it:
    its FLOPs at `peak` (default the bf16 tensor-core peak) or its bytes at
    the HBM3 rate."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sdpa_ms(q, k, v, do=None):
    """The yardstick: torch's scaled_dot_product_attention on contiguous
    copies of the same q, k, v (forward; with `do`, the backward alone)."""
    import torch
    import torch.nn.functional as F

    q, k, v = (x.detach().contiguous().requires_grad_(do is not None)
               for x in (q, k, v))
    if do is None:
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    out = F.scaled_dot_product_attention(q, k, v)
    do = do.contiguous()
    return cuda_ms(lambda: torch.autograd.grad(out, (q, k, v), do,
                                               retain_graph=True))


def launched_kernels(fn) -> set:
    """The names of the CUDA kernels one call of fn launches (a
    torch.profiler trace of the call, made twice in the session: a
    session can miss the first launches it should record). A session
    has also been seen to record no device event at all, in the middle of
    a run whose sessions before and after recorded theirs: such a session
    says nothing of what fn launched, and is made again, up to
    TRACE_TRIES sessions in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type.name == "CUDA"
                 and getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0)) > 0}
        if names:
            return names
        log(f"[trace] profiler session {attempt} of {TRACE_TRIES} recorded "
            f"no device event")
    return set()


def only_kernel(fn, name: str, tag: str) -> None:
    """Of the port's kernels (csrc/'s, in their sources' anonymous
    namespaces), one call of fn launches the kernel `name` alone; PyTorch's
    own kernels (the wrapper's sum of K3's partials) are not counted."""
    only_kernels(fn, [name], tag)


def seeded_bf16(shape, seed: int, dev, dtype=None, scale: float = 1.0):
    """Seeded standard normals (times `scale`) on `dev`, bf16 unless
    `dtype` says otherwise."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype or torch.bfloat16)


def route_copies(fa, fb, before: int, qkv, h, do=None, o=None) -> None:
    """The call just made on these buffers took `padded_copy` once exactly
    when the dispatch rule says so."""
    want = int(fa.attn_kernel_route(qkv, h, do, o) == "tensor_cores_copy")
    check(fb.COPIES - before == want,
          f"{qkv.dtype} {tuple(qkv.shape)} H={h}: {fb.COPIES - before} "
          f"copies, the route says {want}")


def phase_kernel(fa, dev):
    import torch

    from vision_transformers_torch_xla_tpu_torch.ops import (
        flash_blocked as fb,
    )

    results = {}
    worst = 0.0
    cases = [("bfloat16", sh)
             for sh in MAIN_SHAPES + EVAL_SHAPES + EXTRA_SHAPES] + [
        (dt, sh) for dt in EDGE_DTYPES for sh in TC_EDGE_SHAPES]
    for dt_name, shape in cases:
        b, s, h, d = shape
        dt = getattr(torch, dt_name)
        qkv = seeded_bf16((b, s, 3 * h * d), 1000 + b * s + h * d, dev, dt)
        scale = d ** -0.5
        copies = fb.COPIES
        o_k, st_k = fa.attn_fwd(qkv, h, scale, with_stats=True)
        route_copies(fa, fb, copies, qkv, h)
        o9 = fa.hp_fwd(qkv, h, scale)
        o_r, st_r = fa.attn_fwd_reference(qkv, h, scale, with_stats=True)
        torch.cuda.synchronize()
        o_err = (o_k.float() - o_r.float()).abs().max().item()
        o9_err = (o9.float() - o_r.float()).abs().max().item()
        st_err = ((st_k - st_r).abs() / (st_r.abs() + 1e-6)).max().item()
        tag = f"{dt_name} {shape}"
        check(o_k.shape == (b, s, h * d) and st_k.shape == (b, h, s, 2),
              f"{tag}: output shapes {o_k.shape}, {st_k.shape}")
        check(torch.isfinite(o_k.float()).all().item(),
              f"{tag}: o not finite")
        check(o_err <= O_ATOL, f"{tag}: o max abs err {o_err} > {O_ATOL}")
        check(o9_err <= O_ATOL,
              f"{tag}: hp_fwd (K9) max abs err {o9_err} > {O_ATOL}")
        check(st_err <= ST_RTOL, f"{tag}: stats rel err {st_err} > {ST_RTOL}")
        if dt_name == "bfloat16":
            worst = max(worst, o_err, o9_err)
        row = {"o_max_abs_err": o_err, "hp_fwd_max_abs_err": o9_err,
               "stats_max_rel_err": st_err}
        if shape in MAIN_SHAPES:
            row["ms"] = cuda_ms(lambda: fa.attn_fwd(qkv, h, scale))
            row["plain_ms"] = cuda_ms(
                lambda: fa.attn_fwd_reference(qkv, h, scale))
            row["library_ms"] = sdpa_ms(*fb.heads(qkv, h))
            # qkv read once, o written once; q·kᵀ and p·v
            row["bound_ms"], row["bound_by"] = bound(
                4 * b * h * s * s * d, 2 * (b * s * 3 * h * d + b * s * h * d))
            results[shape] = row
        log(f"[kernel] {dt_name} B={b} S={s} H={h} D={d}: "
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    return results, worst


def load_seeded(model, ckpt_path, gamma=None):
    """Seeded weights for `model`, saved to and strict-loaded from a .pth
    through ckpt/convert.py."""
    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        load_checkpoint,
        save_checkpoint,
    )
    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_state_dict,
    )

    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    save_checkpoint(ckpt_path, seeded_state_dict(shapes, seed=0, gamma=gamma))
    model.load_state_dict(load_checkpoint(ckpt_path), strict=True)


def phase_model(counts, dev, ckpt_path, name="my_vit_b", gamma=None,
                tag="model"):
    """The model's bf16 forward against the JAX fp32 golden logits;
    returns the launches of one forward (counts() after a reset)."""
    import numpy as np
    import torch

    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_images,
    )
    from vision_transformers_torch_xla_tpu_torch.models import create_model

    with open(os.path.join(REPO, "tests", "data",
                           f"torch_port_golden_{name}.json")) as f:
        golden = json.load(f)
    img = golden.get("img_size", 224)
    check(gamma is None or f"gamma={gamma}" in golden["weights"],
          f"golden weights {golden['weights']} are not gamma={gamma}")
    model = create_model(name, device=dev, img_size=img,
                         use_pallas_attn=True, **golden["model_kwargs"])
    load_seeded(model, ckpt_path, gamma)
    model.eval()
    images = torch.from_numpy(seeded_images(2, img, seed=0)).to(dev)

    counts(reset=True)
    with torch.inference_mode():
        logits = model(images)
    torch.cuda.synchronize()
    launches = counts()

    want = np.asarray(golden["logits"], np.float32)
    got = logits.cpu().numpy()
    check(got.shape == want.shape == (2, 1000), f"logits shape {got.shape}")
    check(np.isfinite(got).all(), "logits not finite")
    max_abs = float(np.abs(got - want).max())
    rel_l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log(f"[{tag}] {name} bf16 vs JAX fp32 golden: max_abs_err={max_abs!r} "
        f"rel_l2={rel_l2!r} top1 port={got.argmax(1).tolist()} "
        f"golden={want.argmax(1).tolist()} kernel launches={launches}")
    check(max_abs <= LOGIT_ATOL, f"logits max abs err {max_abs} > {LOGIT_ATOL}")
    check(rel_l2 <= LOGIT_REL_L2,
          f"logits rel L2 err {rel_l2} > {LOGIT_REL_L2}")
    return launches


def phase_serve(counts, ckpt_path, name="my_vit_b", tag="serve",
                requests=N_REQUESTS, **engine_kw):
    """`requests` requests to the port's HTTP server, which builds its
    model without use_pallas_attn, as the JAX server does: no request may
    launch any of the kernels that counts() counts. Returns the launches
    (of the engine's warm-up and the requests) and the median latency in
    ms."""
    import numpy as np

    from vision_transformers_torch_xla_tpu_torch.data import native
    from vision_transformers_torch_xla_tpu_torch.launch.serve import (
        InferenceEngine,
        serve,
    )

    jpegs = []
    for i in range(4):
        with open(os.path.join(REPO, "tests", "data", f"serve_{i}.jpg"),
                  "rb") as f:
            jpegs.append(f.read())

    counts(reset=True)
    engine = InferenceEngine(name, ckpt=ckpt_path, device="cuda", **engine_kw)
    server = serve(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    latencies, replies = [], []
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        check(health["status"] == "ok" and health["model"] == name,
              f"/healthz replied {health}")
        for i in range(requests):
            req = urllib.request.Request(url + "/predict", data=jpegs[i % 4],
                                         method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=60) as r:
                reply = json.loads(r.read())
            latencies.append((time.perf_counter() - t0) * 1e3)
            topk = reply["topk"]
            probs = [p for _, p in topk]
            check(len(topk) == 5 and all(0.0 <= p <= 1.0 for p in probs)
                  and probs == sorted(probs, reverse=True),
                  f"request {i}: bad top-5 {reply}")
            check(not any(counts().values()),
                  f"request {i}: the server launched {counts()}")
            replies.append(topk)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    launches = sum(counts().values())

    # the served answer is the model's answer on the decoded image
    direct = engine._forward(engine._decode(jpegs[0])[None])[0]
    want = np.argsort(direct)[::-1][:5].tolist()
    check([c for c, _ in replies[0]] == want,
          f"served {replies[0]}, model top-5 {want}")
    check(requests <= 4 or replies[0] == replies[4],
          "same JPEG, different answers")
    decoder = "native" if native.available() else "PIL"
    log(f"[{tag}] {name} decoder={decoder} requests={requests} "
        f"median_ms={statistics.median(latencies)!r} "
        f"latencies_ms={latencies!r} kernel launches={launches} (plain "
        f"attention, as the JAX server)")
    return launches, statistics.median(latencies)


def build_all(fa, fb, mf):
    """Start every kernel build at once, one nvcc per source; returns each
    library's build (or load) time in seconds. A failed build raises."""
    from concurrent.futures import ThreadPoolExecutor

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    builds = {"attn_fwd_tc": fa.build_tc_kernels,
              "attn_bwd_tc": fa.build_tc_bwd_kernels,
              "attn_fwd": fa.build_kernels, "attn_bwd": fa.build_bwd_kernels,
              "flash_fwd": fb.build_fwd_kernels,
              "flash_bwd": fb.build_bwd_kernels,
              "flash_blocked": fb.build_kernels, "mlp_fused": mf.build_kernels,
              "hp_bwd": fa.build_hp_bwd_kernels,
              "hp_bwd_tc": fa.build_hp_bwd_tc_kernels,
              "fused_attn_fwd": fa.build_fused_fwd_kernels}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {n: pool.submit(timed, fn) for n, fn in builds.items()}
        return {n: f.result() for n, f in futures.items()}


def log_ptxas(cuda_build, name: str, tag: str, untyped: str = "bf16") -> None:
    """ptxas's registers and spills for each kernel of library `name`; a
    kernel with no element type in its name is `untyped`'s (bf16 for the
    tensor-core sources, fp32 for the float-only kernels)."""
    import re

    fn = "?"
    for line in cuda_build.BUILD_LOGS.get(name, "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            # the kernel's own name is the last match: the anonymous
            # namespace before it carries the source's name; then the
            # element type (none: bf16), the head dim and, for
            # attn_fwd_tc_kernel, the cast order (true: K7's)
            k = re.findall(r"\d((?:fused|attn|flash|hp|fc2)_\w+?_kernel)"
                           r"(?:I(13__nv_bfloat16|6__half|f)?(?:Li(\d+)E)?"
                           r"(?:Lb([01])E)?)?", m.group(1))
            dt = {"6__half": "fp16", "f": "fp32", "13__nv_bfloat16": "bf16"
                  }.get(k[-1][1], untyped) if k else ""
            order = ", K7 order" if k and k[-1][3] == "1" else ""
            fn = f"{k[-1][0]}<{dt}, {k[-1][2] or '-'}{order}>" if k \
                else m.group(1)
        elif "registers" in line or "spill" in line:
            log(f"[{tag}] {fn}: {line.strip()}")


def phase_bwd_kernel(fa, dev):
    import torch

    from vision_transformers_torch_xla_tpu_torch.ops import (
        flash_blocked as fb,
    )

    results = {}
    worst = 0.0
    cases = [("bfloat16", sh) for sh in BWD_MAIN_SHAPES + EXTRA_SHAPES] + [
        (dt, sh) for dt in EDGE_DTYPES for sh in TC_EDGE_SHAPES]
    for dt_name, shape in cases:
        b, s, h, d = shape
        dt = getattr(torch, dt_name)
        seed = 2000 + b * s + h * d
        qkv = seeded_bf16((b, s, 3 * h * d), seed, dev, dt)
        do = seeded_bf16((b, s, h * d), seed + 1, dev, dt)
        scale = d ** -0.5
        o, st = fa.attn_fwd(qkv, h, scale, with_stats=True)
        copies = fb.COPIES
        dqkv, dbias = fa.attn_bwd(qkv, do, o, st, h, scale)
        route_copies(fa, fb, copies, qkv, h, do, o)
        # no float atomics: a second run on the same inputs is bitwise equal
        dqkv2, dbias2 = fa.attn_bwd(qkv, do, o, st, h, scale)
        dqkv_r, dbias_r = fa.attn_bwd_reference(qkv, do, o, st, h, scale)
        o_r, st_r = fa.attn_fwd_reference(qkv, h, scale, with_stats=True)
        torch.cuda.synchronize()
        tag = f"{dt_name} {shape}"
        # K2's inputs come from K1 at this shape: hold them too
        o_err = (o.float() - o_r.float()).abs().max().item()
        st_err = ((st - st_r).abs() / (st_r.abs() + 1e-6)).max().item()
        check(o_err <= O_ATOL, f"{tag}: K1's o max abs err {o_err} > {O_ATOL}")
        check(st_err <= ST_RTOL,
              f"{tag}: K1's stats rel err {st_err} > {ST_RTOL}")
        check(torch.equal(dqkv, dqkv2) and torch.equal(dbias, dbias2),
              f"{tag}: two runs of K2 on the same inputs differ")
        check(dqkv.shape == (b, s, 3 * h * d) and dbias.shape == (b, 3 * h * d),
              f"{tag}: output shapes {dqkv.shape}, {dbias.shape}")
        check(torch.isfinite(dqkv.float()).all().item()
              and torch.isfinite(dbias).all().item(), f"{tag}: not finite")
        err = (dqkv.float() - dqkv_r.float()).abs().max().item()
        ref = dqkv_r.float().abs().max().item()
        b_err = (dbias - dbias_r).abs().max().item()
        b_ref = dbias_r.abs().max().item()
        check(err <= DQKV_REL_ATOL * ref,
              f"{tag}: dqkv max abs err {err} > {DQKV_REL_ATOL} x {ref}")
        check(b_err <= DBIAS_REL_ATOL * b_ref,
              f"{tag}: bias partials err {b_err} > {DBIAS_REL_ATOL} x "
              f"{b_ref}")
        if dt_name == "bfloat16":
            worst = max(worst, err)
        row = {"dqkv_max_abs_err": err, "dqkv_max_abs": ref,
               "dbias_max_abs_err": b_err, "dbias_max_abs": b_ref,
               "bitwise_repeat": True, "fwd_o_max_abs_err": o_err,
               "fwd_stats_max_rel_err": st_err}
        if shape in BWD_MAIN_SHAPES:
            row["ms"] = cuda_ms(lambda: fa.attn_bwd(qkv, do, o, st, h, scale))
            row["plain_ms"] = cuda_ms(
                lambda: fa.attn_bwd_reference(qkv, do, o, st, h, scale))
            row["library_ms"] = sdpa_ms(
                *fb.heads(qkv, h), do.view(b, s, h, d).transpose(1, 2))
            # qkv, dO, o, stats read; dqkv and the bias partials written;
            # the products the function needs: s, dp, dv, dk and dq (the
            # kernels compute s and dp once more, not counted)
            row["bound_ms"], row["bound_by"] = bound(
                10 * b * h * s * s * d,
                2 * (2 * b * s * 3 * h * d + 2 * b * s * h * d)
                + 4 * (b * h * s * 2 + b * 3 * h * d))
            results[shape] = row
        log(f"[bwd kernel] {dt_name} B={b} S={s} H={h} D={d}: "
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    return results, worst


def phase_grad(counts, dev, ckpt_path, name="my_vit_b", tag="grad",
               limits=(LOSS_ATOL, GRAD_NORM_RTOL, PARAM_GRAD_NORM_RTOL),
               keep=None, **model_kw):
    """One train-mode forward + backward against the JAX fp32 train golden,
    within `limits` (loss abs, grad norm rel, per-parameter grad norm rel);
    returns the launches (counts() after a reset). `model_kw` goes to
    create_model beside the golden's own; `keep`, a dict, receives every
    parameter's gradient."""
    import numpy as np
    import torch

    from vision_transformers_torch_xla_tpu_torch.ckpt.convert import (
        load_checkpoint,
    )
    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_images,
    )
    from vision_transformers_torch_xla_tpu_torch.models import create_model
    from vision_transformers_torch_xla_tpu_torch.train.losses import (
        soft_target_cross_entropy,
    )
    from vision_transformers_torch_xla_tpu_torch.train.mixup import (
        smoothed_one_hot,
    )

    with open(os.path.join(REPO, "tests", "data",
                           f"torch_port_train_golden_{name}.json")) as f:
        golden = json.load(f)
    img = golden.get("img_size", 224)
    model = create_model(name, device=dev, img_size=img, use_pallas_attn=True,
                         **golden["model_kwargs"], **model_kw)
    model.load_state_dict(load_checkpoint(ckpt_path), strict=True)
    images = torch.from_numpy(seeded_images(2, img, seed=0)).to(dev)
    targets = smoothed_one_hot(torch.tensor(golden["labels"], device=dev),
                               1000, golden["smoothing"])

    counts(reset=True)
    logits = model(images, deterministic=False,
                   generator=torch.Generator(device=dev))
    loss = soft_target_cross_entropy(logits, targets)
    loss.backward()
    torch.cuda.synchronize()
    launches = counts()

    norms = {k: p.grad.float().norm().item()
             for k, p in model.named_parameters()}
    want = golden["grad_norms"]
    check(set(norms) == set(want), "parameter names differ from the golden")
    check(all(np.isfinite(v) for v in norms.values()), "grads not finite")
    grad_norm = float(np.sqrt(sum(v * v for v in norms.values())))
    rel = {k: abs(norms[k] - want[k]) / want[k] for k in want}
    worst = max(rel, key=rel.get)
    loss_err = abs(loss.item() - golden["loss"])
    gn_err = abs(grad_norm - golden["grad_norm"]) / golden["grad_norm"]
    dt = str(model_kw.get("dtype", torch.bfloat16)).split(".")[-1]
    log(f"[{tag}] {name} {dt} vs JAX fp32 golden: loss {loss.item()!r} "
        f"(golden {golden['loss']!r}, abs err {loss_err!r}); grad norm "
        f"{grad_norm!r} (golden {golden['grad_norm']!r}, rel err {gn_err!r}); "
        f"per-parameter grad norm worst rel err {rel[worst]!r} ({worst}), "
        f"median {float(np.median(list(rel.values())))!r}; launches "
        f"{launches}")
    loss_atol, gn_rtol, param_rtol = limits
    check(loss_err <= loss_atol, f"loss err {loss_err} > {loss_atol}")
    check(gn_err <= gn_rtol, f"grad norm rel err {gn_err} > {gn_rtol}")
    check(rel[worst] <= param_rtol,
          f"{worst}: grad norm rel err {rel[worst]} > {param_rtol}")
    if keep is not None:
        keep.update({k: p.grad.detach().clone()
                     for k, p in model.named_parameters()})
    return launches


class swap_blocked:
    """Within it, ops/flash_blocked.py's wrappers are replaced. plain=True:
    the plain versions run on the card, no kernel launches (the witness of
    phase 14). plain=False: each wrapper launches its kernel, then the plain
    version runs on the same inputs, the model's own data; `worst` keeps
    each output's largest error over the plain version's max |.| (o and the
    grads) or absolute (lse)."""

    NAMES = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")

    def __init__(self, fb, plain: bool):
        self.fb, self.plain, self.worst = fb, plain, {}
        self.saved = {n: getattr(fb, n) for n in self.NAMES}

    def note(self, name, got, ref, relative=True):
        err = (got.float() - ref.float()).abs().max().item()
        if relative:
            err /= ref.float().abs().max().item()
        self.worst[name] = max(self.worst.get(name, 0.0), err)

    def __enter__(self):
        fb, kernel = self.fb, self.saved

        def fwd(q, k, v, scale=None):
            ref = fb.flash_fwd_reference(q, k, v, fb._scale(q, scale))
            if self.plain:
                return ref
            o, lse = kernel["flash_fwd"](q, k, v, scale)
            self.note("o", o, ref[0])
            self.note("lse", lse, ref[1], relative=False)
            return o, lse

        def dkdv(q, k, v, do, lse, delta, dk, dv, scale=None):
            ref = fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                              fb._scale(q, scale))
            if self.plain:
                return dk.copy_(ref[0]), dv.copy_(ref[1])
            kernel["flash_bwd_dkdv"](q, k, v, do, lse, delta, dk, dv, scale)
            self.note("dk", dk, ref[0])
            self.note("dv", dv, ref[1])
            return dk, dv

        def dq(q, k, v, do, lse, delta, dq, scale=None):
            ref = fb.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                            fb._scale(q, scale))
            if self.plain:
                return dq.copy_(ref)
            kernel["flash_bwd_dq"](q, k, v, do, lse, delta, dq, scale)
            self.note("dq", dq, ref)
            return dq

        fb.flash_fwd, fb.flash_bwd_dkdv, fb.flash_bwd_dq = fwd, dkdv, dq
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.fb, n, fn)


def phase_train(counts, dev, flags, batch, img=224, patch=16,
                fixed_batch=True, warmup=WARMUP_STEPS, timed=TIMED_STEPS,
                tag="train", inspect=None):
    """launch/main.py::main with `flags`, then (fixed_batch) the loss on
    one fixed batch, then (but with timed=None) the recipe's step timed on
    a fixed device batch; `inspect(ctx)` then looks at the timed trainer's
    state. Returns main()'s launches (counts() after a reset) and the
    timings (main()'s stats with timed=None)."""
    import gc
    import math

    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.data.loader import to_device
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
    from vision_transformers_torch_xla_tpu_torch.obs.metrics import (
        vit_train_flops_per_image,
    )

    # the trainer's entry point, as a user calls it
    cfg = config_from_args(flags)
    counts(reset=True)
    t0 = time.perf_counter()
    stats = trainer.main(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    log(f"[{tag}] main(): {wall:.3f} s, stats {stats}, launches {launches}")
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for v in stats.values()), f"stats not finite: {stats}")
    check(stats["count"] == EVAL_BATCHES * cfg.eval_batch_size(),
          f"evaluated {stats['count']} images")
    if timed is None:
        return launches, stats

    if fixed_batch:
        # the loss falls on one fixed batch (mixup off, constant lr 1e-4)
        fixed = config_from_args(flags + [
            "--mixup", "0", "--cutmix", "0", "--lr", "1e-4", "--min_lr",
            "1e-4", "--warmup_epochs", "0"])
        ctx = trainer.setup(fixed)
        images, labels = to_device(next(iter(ctx.train_ds)), dev)
        losses = []
        for _ in range(FIXED_STEPS):
            ctx.state, m = ctx.train_step(ctx.state, images, labels,
                                          fixed.seed)
            losses.append(m["loss"])
        losses = torch.stack(losses).tolist()
        log(f"[{tag}] fixed batch, {FIXED_STEPS} steps at lr 1e-4: losses "
            f"{losses!r}")
        first, last = sum(losses[:3]) / 3, sum(losses[-3:]) / 3
        check(last < first, f"loss did not fall: {first} -> {last}")
        del ctx, m
        gc.collect()
        torch.cuda.empty_cache()

    # the recipe's step (mixup, forward, backward, AdamW, EMA) on a fixed
    # device batch; CUDA events around each step, no host data in the loop
    ctx = trainer.setup(cfg)
    images, labels = to_device(next(iter(ctx.train_ds)), dev)
    step_ms, host_ms, peak = time_steps(ctx, images, labels, warmup, timed)
    if inspect is not None:
        inspect(ctx)
    ips = batch / (step_ms / 1e3)
    mfu = vit_train_flops_per_image(img, patch) * ips / H100_BF16_PEAK_FLOPS
    result = {"step_ms": step_ms, "host_step_ms": host_ms,
              "images_per_s": ips, "mfu": mfu, "peak_mem_gib": peak / 2**30}
    log(f"[{tag}] {cfg.model} b{batch} recipe step on {nvidia_smi()}: "
        f"median {step_ms!r} ms over {timed} steps after "
        f"{warmup} warm-up (host clock {host_ms!r} ms/step), "
        f"{ips!r} images/s, MFU {mfu!r} of the {H100_BF16_PEAK_FLOPS:.0f} "
        f"FLOP/s H100 SXM bf16 dense peak (bench.py's analytic FLOPs at "
        f"{img}/{patch}), peak memory {peak / 2**30!r} GiB")
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    return launches, result


def time_steps(ctx, images, labels, warmup, timed):
    """ctx.train_step on one device batch: `warmup` steps, then `timed`
    steps between CUDA events. Returns the median step ms, the host clock's
    ms a step and the peak device memory (bytes) of the timed steps."""
    import math

    import torch

    dev = images.device
    for _ in range(warmup):
        ctx.state, m = ctx.train_step(ctx.state, images, labels,
                                      ctx.cfg.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(timed + 1)]
    t0 = time.perf_counter()
    events[0].record()
    for i in range(timed):
        ctx.state, m = ctx.train_step(ctx.state, images, labels,
                                      ctx.cfg.seed)
        events[i + 1].record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / timed
    step_ms = statistics.median(events[i].elapsed_time(events[i + 1])
                                for i in range(timed))
    check(math.isfinite(m["loss"].item()), "timed steps: loss not finite")
    return step_ms, host_ms, torch.cuda.max_memory_allocated(dev)


def phase_long_kernel(fb, dev):
    """K4, K5 and K6 against their plain versions, on q, k, v and dO read
    by stride from (B, S, ·) buffers as the model's path reads them."""
    import torch

    results = {}
    worst = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    for shape in LONG_MAIN_SHAPES + LONG_EXTRA_SHAPES:
        b, s, h, d = shape
        seed = 3000 + b * s + h * d
        qkv = seeded_bf16((b, s, 3 * h * d), seed, dev)
        q, k, v = fb.heads(qkv, h)
        do = seeded_bf16((b, s, h * d), seed + 1, dev).view(
            b, s, h, d).transpose(1, 2)
        scale = d ** -0.5
        # the backward kernels write into views of one dqkv buffer, as the
        # model's path has them
        dq, dk, dv = fb.heads(torch.empty_like(qkv), h)
        o, lse = fb.flash_fwd(q, k, v, scale)
        o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
        delta = fb.flash_delta(o, do)
        fb.flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, scale)
        dk_r, dv_r = fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                                 scale)
        fb.flash_bwd_dq(q, k, v, do, lse, delta, dq, scale)
        dq_r = fb.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
        torch.cuda.synchronize()
        row = {}
        for name, got, ref, rel in (
                ("o", o, o_r, O_REL_ATOL), ("lse", lse, lse_r, None),
                ("dq", dq, dq_r, DQKV_REL_ATOL), ("dk", dk, dk_r, DQKV_REL_ATOL),
                ("dv", dv, dv_r, DQKV_REL_ATOL)):
            check(got.shape == ref.shape and torch.isfinite(got).all().item(),
                  f"{shape} {name}: shape {tuple(got.shape)} or not finite")
            err = (got.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            limit = LSE_ATOL if rel is None else rel * ref_max
            check(err <= limit, f"{shape} {name}: max abs err {err} > {limit}")
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_max_abs"] = ref_max
        worst["flash_fwd"] = max(worst["flash_fwd"], row["o_max_abs_err"])
        worst["flash_bwd_dkdv"] = max(worst["flash_bwd_dkdv"],
                                      row["dk_max_abs_err"],
                                      row["dv_max_abs_err"])
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"],
                                    row["dq_max_abs_err"])
        if s == 197:  # the regime of K1 and K2: one blocked kernel for both?
            row["flash_fwd_ms"] = cuda_ms(lambda: fb.flash_fwd(q, k, v, scale))
            row["flash_bwd_dkdv_ms"] = cuda_ms(lambda: fb.flash_bwd_dkdv(
                q, k, v, do, lse, delta, dk, dv, scale))
            row["flash_bwd_dq_ms"] = cuda_ms(lambda: fb.flash_bwd_dq(
                q, k, v, do, lse, delta, dq, scale))
        if shape in LONG_MAIN_SHAPES:
            row["flash_fwd_ms"] = cuda_ms(lambda: fb.flash_fwd(q, k, v, scale))
            row["flash_fwd_plain_ms"] = cuda_ms(
                lambda: fb.flash_fwd_reference(q, k, v, scale))
            row["flash_bwd_dkdv_ms"] = cuda_ms(lambda: fb.flash_bwd_dkdv(
                q, k, v, do, lse, delta, dk, dv, scale))
            row["flash_bwd_dkdv_plain_ms"] = cuda_ms(
                lambda: fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                                    scale))
            row["flash_bwd_dq_ms"] = cuda_ms(lambda: fb.flash_bwd_dq(
                q, k, v, do, lse, delta, dq, scale))
            row["flash_bwd_dq_plain_ms"] = cuda_ms(
                lambda: fb.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                                  scale))
            row["sdpa_fwd_ms"] = sdpa_ms(q, k, v)
            row["sdpa_bwd_ms"] = sdpa_ms(q, k, v, do)
            # bf16 q, k, v, dO (2 bytes), fp32 lse and delta (4 bytes):
            # K4 reads q, k, v, writes o, lse; K5 reads q, k, v, dO, lse,
            # delta, writes dk, dv; K6 the same inputs, writes dq
            n, rows = b * s * h * d, b * h * s
            sq = b * h * s * s * d
            for name, flops, nbytes in (
                    ("flash_fwd", 4 * sq, 2 * 4 * n + 4 * rows),
                    ("flash_bwd_dkdv", 8 * sq, 2 * 6 * n + 8 * rows),
                    ("flash_bwd_dq", 6 * sq, 2 * 5 * n + 8 * rows)):
                row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bound(
                    flops, nbytes)
        results[shape] = row
        log(f"[long kernel] B={b} S={s} H={h} D={d}: "
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    for layout, (b, s, h, d) in BLOCKED_EXTRA_CASES:
        case = f"{layout} {(b, s, h, d)}"
        seed = 3500 + b * s + h * d
        q, k, v = k4_operands(fb, layout, b, s, h, d, seed, dev)
        # dO as the model's backward has it: a view of (B, S, H, D) memory
        do = seeded_bf16((b, s, h, d), seed + 7, dev).transpose(1, 2)
        dq, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d),
                                          dtype=torch.bfloat16, device=dev),
                              h)
        copies = fb.COPIES
        o, lse = fb.flash_fwd(q, k, v)
        delta = fb.flash_delta(o, do)
        fb.flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv)
        fb.flash_bwd_dq(q, k, v, do, lse, delta, dq)
        torch.cuda.synchronize()
        copied = fb.COPIES - copies
        # one copy for each of K4, K5 and K6 where TMA cannot read q, k, v
        check(copied == 3 * (not fb.tma_ready(q, k, v)),
              f"K4-K6 {case}: {copied} copies")
        scale = d ** -0.5
        o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
        dk_r, dv_r = fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                                 scale)
        dq_r = fb.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale)
        row = {}
        for name, got, ref, rel in (
                ("o", o, o_r, O_REL_ATOL), ("lse", lse, lse_r, None),
                ("dq", dq, dq_r, DQKV_REL_ATOL), ("dk", dk, dk_r, DQKV_REL_ATOL),
                ("dv", dv, dv_r, DQKV_REL_ATOL)):
            check(got.shape == ref.shape and torch.isfinite(got).all().item(),
                  f"K4-K6 {case} {name}: shape {tuple(got.shape)} or not "
                  f"finite")
            err = (got.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            limit = LSE_ATOL if rel is None else rel * ref_max
            check(err <= limit, f"K4-K6 {case} {name}: max abs err {err} > "
                  f"{limit}")
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_max_abs"] = ref_max
        worst["flash_fwd"] = max(worst["flash_fwd"], row["o_max_abs_err"])
        worst["flash_bwd_dkdv"] = max(worst["flash_bwd_dkdv"],
                                      row["dk_max_abs_err"],
                                      row["dv_max_abs_err"])
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"],
                                    row["dq_max_abs_err"])
        log(f"[long kernel] K4-K6 {layout} B={b} S={s} H={h} D={d} (B·H "
            f"{b * h}): " + " ".join(f"{k_}={v_!r}" for k_, v_ in row.items())
            + f" copied={copied}")
    return results, worst


def k4_operands(fb, layout, b, s, h, d, seed, dev, dtype=None):
    """q, k, v (B, H, S, D), bf16 unless `dtype` says otherwise: views of a
    (B, S, 3·H·D) projection ('qkv'), contiguous ('dense'), or (B, H, D, S)
    memory transposed."""
    if layout == "qkv":
        return fb.heads(seeded_bf16((b, s, 3 * h * d), seed, dev, dtype), h)
    if layout == "dense":
        return [seeded_bf16((b, h, s, d), seed + i, dev, dtype)
                for i in range(3)]
    return [seeded_bf16((b, h, d, s), seed + i, dev, dtype).transpose(-1, -2)
            for i in range(3)]


def tc_blocked_edges(fb, dev) -> dict:
    """The tensor-core K4 and K5 at TC_BLOCKED_EDGE_CASES against their
    plain versions (K5 on the plain forward's lse and delta, into views of
    one dqkv buffer), a copy exactly where the route says; returns the
    worst error over the largest plain magnitude per (dtype, kernel)."""
    import torch

    worst = {}
    for dt_name, layout, (b, s, h, d) in TC_BLOCKED_EDGE_CASES:
        dt = getattr(torch, dt_name)
        tag = f"tc blocked {dt_name} {layout} {(b, s, h, d)}"
        seed = 9000 + s + d
        q, k, v = k4_operands(fb, layout, b, s, h, d, seed, dev, dt)
        do = seeded_bf16((b, s, h, d), seed + 5, dev, dt).transpose(1, 2)
        routes = {n: fb.kernel_route(n, q, k, v, do)
                  for n in ("flash_fwd", "flash_bwd_dkdv")}
        want = "tensor_cores" if d % 8 == 0 else "tensor_cores_copy"
        check(set(routes.values()) == {want}, f"{tag}: routes {routes}")
        scale = d ** -0.5
        o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
        delta = fb.flash_delta(o_r, do)
        _, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d), dtype=dt,
                                         device=dev), h)
        copies = fb.COPIES
        o, lse = fb.flash_fwd(q, k, v, scale)
        fb.flash_bwd_dkdv(q, k, v, do, lse_r, delta, dk, dv, scale)
        torch.cuda.synchronize()
        check(fb.COPIES - copies == 2 * (want != "tensor_cores"),
              f"{tag}: {fb.COPIES - copies} copies, route {want}")
        dk_r, dv_r = fb.flash_bwd_dkdv_reference(q, k, v, do, lse_r, delta,
                                                 scale)
        err = (lse - lse_r).abs().max().item()
        check(err <= LSE_ATOL, f"{tag} lse: max abs err {err}")
        # dk and dv to the call's largest gradient: at S = 1, ds = p (dO·v
        # - dO·o) is 0 but for rounding (o = v), and so is dk
        grad_max = max(dk_r.float().abs().max().item(),
                       dv_r.float().abs().max().item())
        for name, kernel, got, ref in (("o", "flash_fwd", o, o_r),
                                       ("dk", "flash_bwd_dkdv", dk, dk_r),
                                       ("dv", "flash_bwd_dkdv", dv, dv_r)):
            check(got.dtype == dt and torch.isfinite(got.float()).all().item(),
                  f"{tag} {name}: {got.dtype} or not finite")
            err = (got.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item() if name == "o" \
                else grad_max
            check(err <= WIDE_REL[dt_name] * ref_max,
                  f"{tag} {name}: max abs err {err} of max |plain| {ref_max}")
            worst[(dt_name, kernel)] = max(worst.get((dt_name, kernel), 0.0),
                                           err / max(ref_max, 1e-30))
    return worst


def trace_tc_blocked() -> None:
    """One call of each tensor-core K4 and K5 at TC_BLOCKED_TRACED, and of
    K6 at TC_BLOCKED_K6_TRACED, each traced alone (only_kernel): each
    launches its csrc/flash_fwd.cu or csrc/flash_bwd.cu kernel (which take
    tensor maps), K6 past 128 flash_bwd_dq_tc_wide_kernel.
    Run in a process of its own (phase 17d): a process's profiler sessions
    stop recording after a few dozen."""
    import torch

    sys.path.insert(0, REPO)
    from vision_transformers_torch_xla_tpu_torch.ops import (
        flash_blocked as fb,
    )

    dev = torch.device("cuda", 0)
    b, s, h = 1, 1100, 2
    for dt_name, d in sorted(set(TC_BLOCKED_TRACED + TC_BLOCKED_K6_TRACED)):
        dt = getattr(torch, dt_name)
        t = {"bfloat16": "__nv_bfloat16", "float16": "__half"}[dt_name]
        kd = next(x for x in (64, 128, 192, 256) if d <= x)
        q, k, v = k4_operands(fb, "qkv", b, s, h, d, 9500 + d, dev, dt)
        do = seeded_bf16((b, s, h, d), 9501 + d, dev, dt).transpose(1, 2)
        o, lse = fb.flash_fwd_reference(q, k, v, d ** -0.5)
        delta = fb.flash_delta(o, do)
        dq, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d), dtype=dt,
                                          device=dev), h)
        tag = f"tc blocked trace {dt_name} D={d}"
        if (dt_name, d) in TC_BLOCKED_TRACED:
            only_kernel(lambda: fb.flash_fwd(q, k, v),
                        f"::flash_fwd_kernel<{t}, {kd}>(CUtensorMap", tag)
            only_kernel(lambda: fb.flash_bwd_dkdv(q, k, v, do, lse, delta,
                                                  dk, dv),
                        f"::flash_bwd_dkdv_kernel<{t}, {kd}>(CUtensorMap",
                        tag)
        if (dt_name, d) in TC_BLOCKED_K6_TRACED:
            k6 = "flash_bwd_dq_kernel" if d <= 128 \
                else "flash_bwd_dq_tc_wide_kernel"
            only_kernel(lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, dq),
                        f"::{k6}<{t}, {kd}>(CUtensorMap", tag)
    log("[tc blocked trace] every call launched its kernel alone")


def tc_k6_edges(fb, dev) -> float:
    """The tensor-core K6 at TC_K6_EDGE_CASES against its plain version on
    the plain forward's lse and delta, into a view of one dqkv buffer, a
    copy exactly where the route says, each call twice and bitwise equal;
    returns the worst error over the call's largest plain gradient per
    dtype."""
    import torch

    worst = {}
    for dt_name, layout, (b, s, h, d) in TC_K6_EDGE_CASES:
        dt = getattr(torch, dt_name)
        tag = f"tc K6 {dt_name} {layout} {(b, s, h, d)}"
        seed = 9100 + s + d
        q, k, v = k4_operands(fb, layout, b, s, h, d, seed, dev, dt)
        do = seeded_bf16((b, s, h, d), seed + 5, dev, dt).transpose(1, 2)
        route = fb.kernel_route("flash_bwd_dq", q, k, v, do)
        want = "tensor_cores" if d % 8 == 0 else "tensor_cores_copy"
        check(route == want, f"{tag}: route {route}")
        scale = d ** -0.5
        o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
        delta = fb.flash_delta(o_r, do)
        dq, _, _ = fb.heads(torch.empty((b, s, 3 * h * d), dtype=dt,
                                        device=dev), h)
        again = torch.empty_like(dq)
        copies = fb.COPIES
        fb.flash_bwd_dq(q, k, v, do, lse_r, delta, dq, scale)
        fb.flash_bwd_dq(q, k, v, do, lse_r, delta, again, scale)
        torch.cuda.synchronize()
        check(fb.COPIES - copies == 2 * (want != "tensor_cores"),
              f"{tag}: {fb.COPIES - copies} copies, route {want}")
        check(torch.equal(dq, again), f"{tag}: two runs differ")
        ref = fb.flash_bwd_reference(q, k, v, o_r, lse_r, do, scale)
        grad_max = max(r.float().abs().max().item() for r in ref)
        check(dq.dtype == dt and torch.isfinite(dq.float()).all().item(),
              f"{tag}: {dq.dtype} or not finite")
        err = (dq.float() - ref[0].float()).abs().max().item()
        check(err <= WIDE_REL[dt_name] * grad_max,
              f"{tag}: max abs err {err} of the largest gradient {grad_max}")
        worst[dt_name] = max(worst.get(dt_name, 0.0),
                             err / max(grad_max, 1e-30))
    return worst


def tc_blocked_calls(fb, shape, dt, seed, dev) -> dict:
    """K4's, K5's and K6's calls at `shape` in dtype `dt`, on q, k, v views
    of one (B, S, 3·H·D) buffer and dO a view of (B, S, H, D) memory, drawn
    on the card from `seed` (at (32, 1370, 12, 256) a host draw of the ~1
    GB takes seconds), K5 and K6 on the plain forward's lse and delta:
    {name: (the wrapper, its plain version, SDPA's ms, FLOPs, bytes)}, the
    FLOPs and bytes as dtype_case counts them."""
    import torch

    b, s, h, d = shape
    scale = d ** -0.5
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device=dev).to(dt)
    do = torch.randn((b, s, h, d), generator=g, device=dev).to(
        dt).transpose(1, 2)
    q, k, v = fb.heads(qkv, h)
    o, lse = fb.flash_fwd_reference(q, k, v, scale)
    delta = fb.flash_delta(o, do)
    del o
    dq, dk, dv = fb.heads(torch.empty_like(qkv), h)
    e = DTYPE_PEAK[str(dt).split(".")[-1]][1]
    sq, n, rows = b * h * s * s * d, b * s * h * d, b * h * s
    return {
        "flash_fwd": (lambda: fb.flash_fwd(q, k, v, scale),
                      lambda: fb.flash_fwd_reference(q, k, v, scale),
                      lambda: sdpa_ms(q, k, v), 4 * sq, e * 4 * n + 4 * rows),
        "flash_bwd_dkdv": (
            lambda: fb.flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv, scale),
            lambda: fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                                scale),
            lambda: sdpa_ms(q, k, v, do), 8 * sq, e * 6 * n + 8 * rows),
        "flash_bwd_dq": (
            lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, dq, scale),
            lambda: fb.flash_bwd_dq_reference(q, k, v, do, lse, delta,
                                              scale),
            lambda: sdpa_ms(q, k, v, do), 6 * sq, e * 5 * n + 8 * rows)}


def phase_tc_blocked(counts, fb, dev):
    """Phase 17d: K4, K5 and K6 on the tensor cores in fp16 and at head
    dims 129-256. The edges (tc_blocked_edges, each case launching K4 and
    K5 once; tc_k6_edges, each launching K6 twice) with the counts reset
    just before each; each new kernel timed beside its plain version and
    SDPA (TC_BLOCKED_TIMED); then the traces in a process of its own
    (trace_tc_blocked). Returns the rows per (dtype, kernel, shape) and
    the worst errors per (dtype, kernel)."""
    import gc

    import torch

    counts(reset=True)
    worst = tc_blocked_edges(fb, dev)
    n = len(TC_BLOCKED_EDGE_CASES)
    launched = counts()
    check(launched == only(FLASH_FWD_LAUNCHES=n, FLASH_BWD_DKDV_LAUNCHES=n),
          f"the edge cases launched {launched}, want K4 and K5 {n} each")
    log(f"[tc blocked] {n} edge cases, worst error over max |plain|: "
        f"{worst!r}")
    t_k6 = time.perf_counter()
    counts(reset=True)
    k6_worst = tc_k6_edges(fb, dev)
    n6 = len(TC_K6_EDGE_CASES)
    launched = counts()
    check(launched == only(FLASH_BWD_DQ_LAUNCHES=2 * n6),
          f"the K6 edge cases launched {launched}, want K6 {2 * n6}")
    for dt_name, err in k6_worst.items():
        worst[(dt_name, "flash_bwd_dq")] = err
    log(f"[tc blocked] {n6} K6 edge cases, each twice and bitwise equal, "
        f"worst error over the largest plain gradient: {k6_worst!r}")
    log(f"[time] the K6 edges took {time.perf_counter() - t_k6:.1f} s")
    rows = {}
    for i, (dt_name, shape) in enumerate(TC_BLOCKED_TIMED):
        dt = getattr(torch, dt_name)
        for name, (kernel, plain, library, flops, nbytes) in \
                tc_blocked_calls(fb, shape, dt, 9700 + i, dev).items():
            row = {"ms": cuda_ms(kernel)}
            row["plain_ms"] = cuda_ms(plain, TC_BLOCKED_SLOW_REPS, 1)
            row["library_ms"] = library()
            row["bound_ms"], row["bound_by"] = bound(
                flops, nbytes, DTYPE_PEAK[dt_name][0])
            rows[(dt_name, name, shape)] = row
            log(f"[tc blocked] {dt_name} {name} {shape} on {nvidia_smi()}: "
                + " ".join(f"{k}={v!r}" for k, v in row.items()))
        gc.collect()
        torch.cuda.empty_cache()
    in_child("trace_tc_blocked", "the tensor-core K4-K6 traces")
    return rows, worst


def fp32_wide_blocked_edges(fb, dev) -> dict:
    """The fp32 K4, K5 and K6 past D 128 at FP32_WIDE_BLOCKED_EDGE_SHAPES
    against their plain versions (K5 and K6 on the plain forward's lse and
    delta): each call twice and bitwise equal, no copy, o within
    K2_FP32_EDGE_REL of the plain version's largest magnitude (lse of
    max(its largest, WIDE_M_FLOOR)), dq, dk and dv of the call's largest
    plain gradient. Returns the worst error of o (K4), of dk and dv (K5)
    and of dq (K6)."""
    import torch

    worst = {"flash_fwd": 0.0, "flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    for layout, (b, s, h, d) in FP32_WIDE_BLOCKED_EDGE_SHAPES:
        tag = f"fp32 wide K4-K6 edge {layout} (B, S, H, D) = {(b, s, h, d)}"
        q, k, v, do = fp32_bwd_operands(fb, layout, b, s, h, d,
                                        8400 + s + d, dev)
        scale = d ** -0.5
        copies = fb.COPIES
        (o, lse), (o2, lse2) = (fb.flash_fwd(q, k, v) for _ in range(2))
        o_r, lse_r = fb.flash_fwd_reference(q, k, v, scale)
        delta = fb.flash_delta(o_r, do)
        runs = []
        for _ in range(2):
            dq, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d), device=dev),
                                  h)
            fb.flash_bwd_dkdv(q, k, v, do, lse_r, delta, dk, dv)
            fb.flash_bwd_dq(q, k, v, do, lse_r, delta, dq)
            runs.append((dq, dk, dv))
        want = fb.flash_bwd_reference(q, k, v, o_r, lse_r, do, scale)
        torch.cuda.synchronize()
        check(fb.COPIES == copies, f"{tag}: {fb.COPIES - copies} copies")
        check(torch.equal(o, o2) and torch.equal(lse, lse2)
              and all(torch.equal(x, y) for x, y in zip(*runs)),
              f"{tag}: two runs on the same inputs differ")
        o_err = (o - o_r).abs().max().item()
        o_top = o_r.abs().max().item()
        lse_err = (lse - lse_r).abs().max().item()
        lse_top = max(lse_r.abs().max().item(), WIDE_M_FLOOR)
        top = max(w.abs().max().item() for w in want)
        errs = [(g - w).abs().max().item() for g, w in zip(runs[0], want)]
        check(all(torch.isfinite(x).all().item() for x in (o, lse, *runs[0]))
              and o_err <= K2_FP32_EDGE_REL * o_top
              and lse_err <= K2_FP32_EDGE_REL * lse_top
              and max(errs) <= K2_FP32_EDGE_REL * top,
              f"{tag}: o {o_err} of {o_top}, lse {lse_err} of {lse_top}, "
              f"dq, dk, dv {errs} of {top}: over {K2_FP32_EDGE_REL} x them")
        worst["flash_fwd"] = max(worst["flash_fwd"], o_err)
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs[0])
        worst["flash_bwd_dkdv"] = max(worst["flash_bwd_dkdv"], *errs[1:])
        log(f"[fp32 wide blocked] {tag}: o, lse max abs err {o_err!r}, "
            f"{lse_err!r} (largest {o_top!r}, {lse_top!r}); dq, dk, dv "
            f"{errs!r} (largest gradient {top!r}); bitwise repeat True")
        del q, k, v, do, o, lse, o2, lse2, o_r, lse_r, delta, runs, want
    return worst


def phase_fp32_wide_blocked(counts, fb, dev):
    """Phase 17e: the fp32 K4, K5 and K6 at head dims 129-256 on the wide
    register tiles. Their edges (fp32_wide_blocked_edges, each case
    launching each kernel twice) with the counts reset just before; then
    each timed
    at FP32_WIDE_BLOCKED_TIMED beside its plain version, SDPA and its
    bound, and printed beside the loops it replaced
    (REPLACED_WIDE_BLOCKED_MS). Returns the rows per ("float32", kernel,
    shape) and the worst errors per kernel."""
    import gc

    import torch

    counts(reset=True)
    worst = fp32_wide_blocked_edges(fb, dev)
    n = len(FP32_WIDE_BLOCKED_EDGE_SHAPES)
    launched = counts()
    check(launched == only(FLASH_FWD_LAUNCHES=2 * n,
                           FLASH_BWD_DKDV_LAUNCHES=2 * n,
                           FLASH_BWD_DQ_LAUNCHES=2 * n),
          f"the edge cases launched {launched}, want K4, K5 and K6 {2 * n} "
          f"each")
    log(f"[fp32 wide blocked] {n} edge cases, each call twice and bitwise "
        f"equal, worst max abs error: {worst!r}")
    rows = {}
    for i, shape in enumerate(FP32_WIDE_BLOCKED_TIMED):
        calls = tc_blocked_calls(fb, shape, torch.float32, 9800 + i, dev)
        for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
            kernel, plain, library, flops, nbytes = calls[name]
            row = {"ms": cuda_ms(kernel)}
            row["plain_ms"] = cuda_ms(plain, TC_BLOCKED_SLOW_REPS, 1)
            row["library_ms"] = library()
            row["bound_ms"], row["bound_by"] = bound(
                flops, nbytes, DTYPE_PEAK["float32"][0])
            rows[("float32", name, shape)] = row
            log(f"[fp32 wide blocked] float32 {name} {shape} on "
                f"{nvidia_smi()}: "
                + " ".join(f"{k}={v!r}" for k, v in row.items())
                + f" (the loops it replaced: "
                f"{REPLACED_WIDE_BLOCKED_MS[name]} device ms)")
        del calls
        gc.collect()
        torch.cuda.empty_cache()
    return rows, worst


def in_child(fn_name: str, what: str) -> None:
    """Runs chip_smoke.fn_name() in a process of its own (whose profiler
    sessions are its first), logs its output, and fails if it failed."""
    res = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.{fn_name}()"],
        cwd=REPO, capture_output=True, text=True, timeout=STATE_TIMEOUT_S)
    for line in res.stdout.splitlines():
        log(line)
    check(res.returncode == 0, f"{what} failed: {res.stderr[-3000:]}")


def phase_precision(counts):
    """launch/main.py::main on a small ViT of the kernel route's widths:
    --precision fp32 (auto: the kernel route, as in JAX), fp32 with
    --pallas_attn on, fp32 with --pallas_mlp on, then bf16; returns each
    run's launches."""
    import math

    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    out = {}
    for run, flags in PRECISION_RUNS.items():
        cfg = config_from_args(PRECISION_FLAGS + flags)
        counts(reset=True)
        t0 = time.perf_counter()
        stats = trainer.main(cfg)
        torch.cuda.synchronize()
        out[run] = counts()
        log(f"[precision] main() {' '.join(flags)}: "
            f"{time.perf_counter() - t0:.3f} s, stats {stats}, launches "
            f"{out[run]}")
        check(all(isinstance(v, (int, float)) and math.isfinite(v)
                  for v in stats.values()), f"stats not finite: {stats}")
    return out


def phase_long_fp32(counts):
    """launch/main.py::main on the 518-px model with --precision fp32
    (LONG_FP32_FLAGS), under one torch.profiler session; returns the
    launches (counts() after a reset) and {name: launches} of the csrc/
    kernels the session saw (CSRC_KERNEL: PyTorch's own kernels live in
    anonymous namespaces too)."""
    import math
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    cfg = config_from_args(LONG_FP32_FLAGS)
    counts(reset=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        stats = trainer.main(cfg)
        torch.cuda.synchronize()
    launches = counts()
    named = {e.key: e.count for e in prof.key_averages()
             if e.device_type.name == "CUDA" and re.match(CSRC_KERNEL, e.key)}
    log(f"[long fp32] main() {' '.join(LONG_FP32_FLAGS)}: "
        f"{time.perf_counter() - t0:.3f} s, stats {stats}, launches "
        f"{launches}, csrc/ kernels {named}")
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for v in stats.values()), f"stats not finite: {stats}")
    check(stats["count"] == LONG_FP32_EVALS * cfg.eval_batch_size(),
          f"evaluated {stats['count']} images")
    return launches, named


class swap_plain_attention:
    """Within it, ops/flash_attention.py's K1 and K2 wrappers run their
    plain versions on the card: no kernel launches (the fp32 witness of
    phase 22)."""

    def __init__(self, fa):
        self.fa = fa
        self.saved = (fa.attn_fwd, fa.attn_bwd)

    def __enter__(self):
        fa = self.fa

        def fwd(qkv, num_heads, scale=None, with_stats=False):
            return fa.attn_fwd_reference(
                qkv, num_heads, fa._scale(qkv, num_heads, scale), with_stats)

        def bwd(qkv, do, o, st, num_heads, scale=None):
            return fa.attn_bwd_reference(qkv, do, o, st, num_heads,
                                         fa._scale(qkv, num_heads, scale))

        fa.attn_fwd, fa.attn_bwd = fwd, bwd
        return self

    def __exit__(self, *exc):
        self.fa.attn_fwd, self.fa.attn_bwd = self.saved


def unfused_mlp_bwd(dy, w2, h):
    """The default path's backward of fc2 -> gelu_tanh for K3's result:
    da by cuBLAS, autograd's GELU backward, the fp32 bias sum."""
    import torch

    dh = torch.ops.aten.gelu_backward(torch.matmul(dy, w2), h,
                                      approximate="tanh")
    return dh, dh.sum(dim=(0, 1), dtype=torch.float32)


def dtype_case(fa, fb, mf, name, shape, dt, dev):
    """One kernel's call at `shape` in dtype `dt`: (the wrapper, its plain
    version, the PyTorch yardstick's ms or None, FLOPs, bytes, the kind of
    each output, the unfused default path's call or None). Both calls
    return tuples. Kinds: 'rel' (the dtype's own outputs), 'fp32' (row
    stats, bias partials), 'lse'."""
    import torch

    e = DTYPE_PEAK[str(dt).split(".")[-1]][1]
    seed = 7000 + sum(shape) + len(name)
    if name == "fc2_bwd":
        b, s, o, k = shape
        dy = seeded_bf16((b, s, o), seed, dev, dt)
        w2 = seeded_bf16((o, k), seed + 1, dev, dt, 0.02)
        h = seeded_bf16((b, s, k), seed + 2, dev, dt)
        m = b * s
        # dy, w2, h read; dh, a written, db1 (fp32) written; dy·w2
        return (lambda: mf.fc2_bwd(dy, w2, h),
                lambda: mf.fc2_bwd_reference(dy, w2, h), None,
                2 * m * o * k, e * (m * o + o * k + 3 * m * k) + 4 * k,
                ("rel", "rel", "fp32"), lambda: unfused_mlp_bwd(dy, w2, h))
    b, s, h, d = shape
    scale = d ** -0.5
    sq, n, rows = b * h * s * s * d, b * s * h * d, b * h * s
    qkv = seeded_bf16((b, s, 3 * h * d), seed, dev, dt)
    do = seeded_bf16((b, s, h * d), seed + 1, dev, dt)
    q, k, v = fb.heads(qkv, h)
    dob = do.view(b, s, h, d).transpose(1, 2)
    qkv5 = qkv.view(b, s, 3, h, d)
    fwd_lib, bwd_lib = (lambda: sdpa_ms(q, k, v)), \
        (lambda: sdpa_ms(q, k, v, dob))
    if name in ("flash_bwd_dkdv", "flash_bwd_dq"):
        o, lse = fb.flash_fwd_reference(q, k, v, scale)
        delta = fb.flash_delta(o, dob)
        dq, dk, dv = fb.heads(torch.empty_like(qkv), h)
    if name in ("attn_bwd",):
        o1, st = fa.attn_fwd_reference(qkv, h, scale, with_stats=True)
    cases = {
        # K1: qkv read, o and the row stats written; q·kᵀ and p·v
        "attn_fwd": (lambda: fa.attn_fwd(qkv, h, scale, with_stats=True),
                     lambda: fa.attn_fwd_reference(qkv, h, scale,
                                                   with_stats=True),
                     fwd_lib, 4 * sq, e * 4 * n + 8 * rows, ("rel", "fp32")),
        # K2: qkv, dO, o, stats read; dqkv, bias partials written; s, dp,
        # dv, dk, dq (as phase 7 counts them)
        "attn_bwd": (lambda: fa.attn_bwd(qkv, do, o1, st, h, scale),
                     lambda: fa.attn_bwd_reference(qkv, do, o1, st, h,
                                                   scale),
                     bwd_lib, 10 * sq, e * 8 * n + 4 * (2 * rows + 3 * b * h
                                                        * d),
                     ("rel", "fp32")),
        # K4: q, k, v read, o and lse written
        "flash_fwd": (lambda: fb.flash_fwd(q, k, v, scale),
                      lambda: fb.flash_fwd_reference(q, k, v, scale),
                      fwd_lib, 4 * sq, e * 4 * n + 4 * rows, ("rel", "lse")),
        # K5: q, k, v, dO, lse, delta read, dk, dv written
        "flash_bwd_dkdv": (
            lambda: fb.flash_bwd_dkdv(q, k, v, dob, lse, delta, dk, dv,
                                      scale),
            lambda: fb.flash_bwd_dkdv_reference(q, k, v, dob, lse, delta,
                                                scale),
            bwd_lib, 8 * sq, e * 6 * n + 8 * rows, ("rel", "rel")),
        # K6: the same inputs, dq written
        "flash_bwd_dq": (
            lambda: (fb.flash_bwd_dq(q, k, v, dob, lse, delta, dq, scale),),
            lambda: (fb.flash_bwd_dq_reference(q, k, v, dob, lse, delta,
                                               scale),),
            bwd_lib, 6 * sq, e * 5 * n + 8 * rows, ("rel",)),
        # K9, K10: qkv (and dO) read, o (dqkv) written
        "hp_fwd": (lambda: (fa.hp_fwd(qkv, h, scale),),
                   lambda: (fa.attn_fwd_reference(qkv, h, scale)[0],),
                   fwd_lib, 4 * sq, e * 4 * n, ("rel",)),
        "hp_bwd": (lambda: (fa.hp_bwd(qkv, do, h, scale),),
                   lambda: (fa.hp_bwd_reference(qkv, do, h, scale),),
                   bwd_lib, 10 * sq, e * 7 * n, ("rel",)),
        # K7, K8 on the (B, H, S, D) views; K11, K12 on the (B, S, 3, H, D)
        # buffer
        "fused_fwd": (lambda: (fa.fused_fwd(q, k, v, scale),),
                      lambda: (fa.fused_fwd_reference(q, k, v, scale),),
                      fwd_lib, 4 * sq, e * 4 * n, ("rel",)),
        "fused_bwd": (lambda: fa.fused_bwd(q, k, v, dob, scale),
                      lambda: fa.fused_bwd_reference(q, k, v, dob, scale),
                      bwd_lib, 10 * sq, e * 7 * n, ("rel", "rel", "rel")),
        "qkv_fwd": (lambda: (fa.qkv_fwd(qkv5, scale=scale),),
                    lambda: (fa.fused_fwd_reference(q, k, v, scale).transpose(
                        1, 2).reshape(b, s, h * d),),
                    fwd_lib, 4 * sq, e * 4 * n, ("rel",)),
        "qkv_bwd": (lambda: (fa.qkv_bwd(qkv5, do, scale=scale),),
                    lambda: (fa.hp_bwd_reference(qkv, do, h, scale).view(
                        qkv5.shape),),
                    bwd_lib, 10 * sq, e * 7 * n, ("rel",))}
    return (*cases[name], None)


def drive_entry_points(counts, fa, mf, dev, dt):
    """Forward and backward through every entry point that reaches a
    kernel, in dtype `dt`, at the widths of the models' paths (ViT-B's 12
    heads of 64, 768 -> 3072 -> 768 MLP; 197 and 1370 tokens); returns the
    launches (counts() after a reset): one of each kernel."""
    import torch

    from vision_transformers_torch_xla_tpu_torch.ops import (
        multi_head_attention,
    )
    from vision_transformers_torch_xla_tpu_torch.ops.mlp_fused import (
        mlp_gelu,
    )

    def leaf(shape, seed, scale=1.0):
        return seeded_bf16(shape, seed, dev, dt, scale).requires_grad_()

    def backward(o, seed):
        o.backward(seeded_bf16(tuple(o.shape), seed, dev, dt))

    counts(reset=True)
    # K1, K2: the fused projection + attention of a ViT-B block
    backward(fa.qkv_proj_attention(leaf((8, 197, 768), 7100),
                                   leaf((768, 2304), 7101, 0.02),
                                   leaf((2304,), 7102, 0.02), 12), 7103)
    # K3: the fused-backward MLP
    backward(mlp_gelu(leaf((8, 197, 768), 7110), leaf((768, 3072), 7111,
                                                       0.02),
                      leaf((3072,), 7112, 0.02), leaf((3072, 768), 7113,
                                                      0.02),
                      leaf((768,), 7114, 0.02)), 7115)
    # K4-K6 at 1370 tokens (518 px / 14), K9 and K10 at 197
    for s, seed in ((1370, 7120), (197, 7130)):
        backward(fa.fused_attention_qkv_cols(leaf((2, s, 2304), seed), 12),
                 seed + 1)
    # K7, K8 and K11, K12: the op-level entry points
    backward(multi_head_attention(*(leaf((8, 12, 197, 64), 7140 + i)
                                    for i in range(3)), use_pallas=True),
             7143)
    backward(fa.fused_attention_qkv(leaf((8, 197, 3, 12, 64), 7150)), 7151)
    torch.cuda.synchronize()
    return counts()


def phase_dtypes(counts, fa, fb, mf, dev):
    """Every kernel's fp32 and fp16 instantiation: the entry points driven
    once (drive_entry_points), then each kernel held against its plain
    version at its main and ragged shape, and timed at the main shape
    beside its plain version and SDPA. Returns the launches per dtype, the
    rows per (dtype, kernel) and the worst errors per (dtype, kernel)."""
    import gc

    import torch

    launches, rows, worst = {}, {}, {}
    for dt_name in DTYPES:
        dt = getattr(torch, dt_name)
        launches[dt_name] = drive_entry_points(counts, fa, mf, dev, dt)
        log(f"[dtypes] {dt_name}: the entry points launched "
            f"{launches[dt_name]}")
        peak = DTYPE_PEAK[dt_name][0]
        for name, shapes in DTYPE_SHAPES.items():
            for shape in shapes:
                kernel, plain, library, flops, nbytes, kinds, unfused = \
                    dtype_case(fa, fb, mf, name, shape, dt, dev)
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                row = {}
                for i, (g, w, kind) in enumerate(zip(got, want, kinds)):
                    check(g.shape == w.shape and g.dtype == w.dtype
                          and torch.isfinite(g.float()).all().item(),
                          f"{dt_name} {name} {shape} output {i}: "
                          f"{tuple(g.shape)} {g.dtype} or not finite")
                    err = (g.float() - w.float()).abs().max().item()
                    ref = w.float().abs().max().item()
                    limit = {"rel": DTYPE_REL[dt_name] * ref,
                             "fp32": FP32_OUT_REL[dt_name] * ref,
                             "lse": LSE_ATOL}[kind]
                    check(err <= limit, f"{dt_name} {name} {shape} output "
                          f"{i}: max abs err {err} > {limit}")
                    row[f"out{i}_max_abs_err"] = err
                    row[f"out{i}_max_abs"] = ref
                    if kind == "rel":
                        worst[(dt_name, name)] = max(
                            worst.get((dt_name, name), 0.0), err)
                if shape == shapes[0]:
                    row["shape"] = shape
                    row["ms"] = cuda_ms(kernel)
                    row["plain_ms"] = cuda_ms(plain)
                    row["library_ms"] = library() if library else None
                    if unfused:
                        row["unfused_ms"] = cuda_ms(unfused)
                    row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                             peak)
                    rows[(dt_name, name)] = row
                log(f"[dtypes] {dt_name} {name} {shape}: "
                    + " ".join(f"{k}={v!r}" for k, v in row.items()))
                del got, want, kernel, plain, library, unfused
                gc.collect()
                torch.cuda.empty_cache()
    worst[("float32", "attn_bwd")] = max(worst[("float32", "attn_bwd")],
                                         fp32_k2_edges(fa, dev))
    k1_worst = fp32_k1_edges(fa, dev)
    for name in ("attn_fwd", "hp_fwd"):
        worst[("float32", name)] = max(worst[("float32", name)], k1_worst)
    t_k7 = time.perf_counter()
    k7_worst = fp32_k7_edges(fa, fb, dev)
    for name in ("fused_fwd", "qkv_fwd"):
        worst[("float32", name)] = max(worst[("float32", name)], k7_worst)
    log(f"[time] the fp32 K7/K11 edges took {time.perf_counter() - t_k7:.1f}"
        f" s")
    for name, err in fp32_k5k6_edges(fb, dev).items():
        worst[("float32", name)] = max(worst[("float32", name)], err)
    worst[("float32", "flash_fwd")] = max(worst[("float32", "flash_fwd")],
                                          fp32_k4_edges(fb, dev))
    for name, err in fp32_hp_bwd_edges(fa, fb, dev).items():
        worst[("float32", name)] = max(worst[("float32", name)], err)
    for name, was in REPLACED_FP32_MS.items():
        row = rows[("float32", name)]
        log(f"[dtypes] float32 {name} {row['shape']}: {row['ms']!r} ms "
            f"(the kernels it replaced: {was} device ms), plain "
            f"{row['plain_ms']!r}, SDPA {row['library_ms']!r}, bound "
            f"{row['bound_ms']!r}")
    return launches, rows, worst


def fp32_k2_edges(fa, dev) -> float:
    """The fp32 K2 (csrc/attn_bwd.cu) at K2_FP32_EDGE_SHAPES against its
    plain version, on o and the row stats of the fp32 K1: each call run
    twice and bitwise equal, dqkv and the bias partials within
    K2_FP32_EDGE_REL of the plain version's largest magnitude. Returns the
    worst dqkv error."""
    import torch

    worst = 0.0
    for b, s, h, d in K2_FP32_EDGE_SHAPES:
        tag = f"fp32 K2 edge (B, S, H, D) = {(b, s, h, d)}"
        qkv = seeded_bf16((b, s, 3 * h * d), 7500 + s + d, dev, torch.float32)
        do = seeded_bf16((b, s, h * d), 7600 + s + d, dev, torch.float32)
        check(fa.attn_kernel_route(qkv, h, do, do) == "cuda_cores",
              f"{tag}: route {fa.attn_kernel_route(qkv, h, do, do)}")
        o, st = fa.attn_fwd(qkv, h, with_stats=True)
        got, again = fa.attn_bwd(qkv, do, o, st, h), fa.attn_bwd(qkv, do, o,
                                                                 st, h)
        want = fa.attn_bwd_reference(qkv, do, o, st, h, d ** -0.5)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{tag}: two runs on the same inputs differ")
        errs = []
        for what, g, w in zip(("dqkv", "bias partials"), got, want):
            err = (g - w).abs().max().item()
            ref = w.abs().max().item()
            check(torch.isfinite(g).all().item()
                  and err <= K2_FP32_EDGE_REL * ref,
                  f"{tag}: {what} max abs err {err} > {K2_FP32_EDGE_REL} x "
                  f"{ref}")
            errs.append((err, ref))
        worst = max(worst, errs[0][0])
        log(f"[dtypes] {tag}: dqkv max abs err {errs[0][0]!r} (of "
            f"{errs[0][1]!r}), bias partials {errs[1][0]!r} (of "
            f"{errs[1][1]!r}), bitwise repeat True")
        del qkv, do, o, st, got, again, want
    return worst


def fp32_k1_edges(fa, dev) -> float:
    """The fp32 K1 and K9 (csrc/attn_fwd_simt.cuh, attn_fwd_simt_kernel in
    K1's order) at K1_FP32_EDGE_SHAPES against their plain version: K1 run
    twice and K9 once, all three o bitwise equal (and K1's stats), o within
    K2_FP32_EDGE_REL of the plain version's largest magnitude and the row
    stats within K2_FP32_EDGE_REL relative (m past D 128 of max(|m|,
    WIDE_M_FLOOR)). Returns the worst o error."""
    import torch

    worst = 0.0
    for b, s, h, d in K1_FP32_EDGE_SHAPES:
        tag = f"fp32 K1/K9 edge (B, S, H, D) = {(b, s, h, d)}"
        qkv = seeded_bf16((b, s, 3 * h * d), 7700 + s + d, dev,
                          torch.float32)
        check(fa.attn_kernel_route(qkv, h) == "cuda_cores",
              f"{tag}: route {fa.attn_kernel_route(qkv, h)}")
        (o, st), (o2, st2) = (fa.attn_fwd(qkv, h, with_stats=True)
                              for _ in range(2))
        o9 = fa.hp_fwd(qkv, h)
        o_ref, st_ref = fa.attn_fwd_reference(qkv, h, d ** -0.5,
                                              with_stats=True)
        torch.cuda.synchronize()
        check(torch.equal(o, o2) and torch.equal(st, st2)
              and torch.equal(o, o9), f"{tag}: two runs (or K1 and K9) on "
              f"the same inputs differ")
        err, ref = (o - o_ref).abs().max().item(), o_ref.abs().max().item()
        floor = torch.tensor([WIDE_M_FLOOR if d > 128 else 0.0, 0.0],
                             device=dev)
        st_err = ((st - st_ref).abs()
                  / torch.maximum(st_ref.abs(), floor)).max().item()
        check(torch.isfinite(o).all().item() and err <= K2_FP32_EDGE_REL
              * ref and st_err <= K2_FP32_EDGE_REL,
              f"{tag}: o max abs err {err} > {K2_FP32_EDGE_REL} x {ref}, or "
              f"stats relative err {st_err} > {K2_FP32_EDGE_REL}")
        worst = max(worst, err)
        log(f"[dtypes] {tag}: o max abs err {err!r} (of {ref!r}), stats "
            f"relative err {st_err!r}, bitwise repeat True")
        del qkv, o, st, o2, st2, o9, o_ref, st_ref
    return worst


def fp32_k7_operands(layout, b, s, h, d, seed, dev):
    """fp32 (B, H, S, D) q, k, v: contiguous ('dense'), each two floats
    late ('pair_offset': pair-aligned, not 16-byte aligned), with one
    float of padding a row ('odd_row_stride') or one float late
    ('odd_offset')."""
    import torch

    def make(t):
        flat = t.flatten()
        if layout == "pair_offset":
            return torch.cat([flat, flat[:2]])[2:].view(t.shape)
        if layout == "odd_offset":
            return torch.cat([flat, flat[:1]])[1:].view(t.shape)
        if layout == "odd_row_stride":
            return torch.nn.functional.pad(t, (0, 1))[..., :-1]
        return t

    return [make(seeded_bf16((b, h, s, d), seed + i, dev, torch.float32))
            for i in range(3)]


def fp32_k7_edges(fa, fb, dev) -> float:
    """The fp32 K7 and K11 (csrc/attn_fwd_simt.cuh, attn_fwd_simt_kernel in
    K7's order) at K7_FP32_EDGE_SHAPES against their plain version: K7 run
    twice on contiguous (B, H, S, D) q, k, v and K11 once on a (B, S, 3, H,
    D) buffer holding the same heads, all three o bitwise equal, no copy,
    o within K2_FP32_EDGE_REL of the plain version's largest magnitude;
    then K7 on K7_FP32_VIEW_CASES, copied exactly where _launch_views
    copies. Returns the worst o error."""
    import torch

    worst = 0.0
    for b, s, h, d in K7_FP32_EDGE_SHAPES:
        tag = f"fp32 K7/K11 edge (B, S, H, D) = {(b, s, h, d)}"
        qkv = seeded_bf16((b, s, 3, h, d), 7800 + s + d, dev, torch.float32)
        q, k, v = (t.contiguous()
                   for t in qkv.permute(2, 0, 3, 1, 4).unbind(0))
        check(fa.fused_kernel_route(q, k, v) == "cuda_cores",
              f"{tag}: route {fa.fused_kernel_route(q, k, v)}")
        copies = fb.COPIES
        o, o2 = fa.fused_fwd(q, k, v), fa.fused_fwd(q, k, v)
        o11 = fa.qkv_fwd(qkv).view(b, s, h, d).transpose(1, 2)
        o_ref = fa.fused_fwd_reference(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        check(torch.equal(o, o2) and torch.equal(o, o11),
              f"{tag}: two runs (or K7 and K11) on the same inputs differ")
        check(fb.COPIES == copies, f"{tag}: {fb.COPIES - copies} copies")
        err, ref = (o - o_ref).abs().max().item(), o_ref.abs().max().item()
        check(torch.isfinite(o).all().item()
              and err <= K2_FP32_EDGE_REL * ref,
              f"{tag}: o max abs err {err} > {K2_FP32_EDGE_REL} x {ref}")
        worst = max(worst, err)
        log(f"[dtypes] {tag}: o max abs err {err!r} (of {ref!r}), bitwise "
            f"repeat and K7 = K11 True")
        del qkv, q, k, v, o, o2, o11, o_ref
    for layout, (b, s, h, d) in K7_FP32_VIEW_CASES:
        tag = f"fp32 K7 {layout} view (B, S, H, D) = {(b, s, h, d)}"
        q, k, v = fp32_k7_operands(layout, b, s, h, d, 7900 + d, dev)
        copies = fb.COPIES
        o = fa.fused_fwd(q, k, v)
        o_ref = fa.fused_fwd_reference(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        want = int(layout in ("odd_row_stride", "odd_offset"))
        check(fb.COPIES - copies == want,
              f"{tag}: {fb.COPIES - copies} copies, want {want}")
        err, ref = (o - o_ref).abs().max().item(), o_ref.abs().max().item()
        check(torch.isfinite(o).all().item()
              and err <= K2_FP32_EDGE_REL * ref,
              f"{tag}: o max abs err {err} > {K2_FP32_EDGE_REL} x {ref}")
        worst = max(worst, err)
        log(f"[dtypes] {tag}: o max abs err {err!r} (of {ref!r}), copies "
            f"{want}")
        del q, k, v, o, o_ref
    return worst


def fp32_bwd_operands(fb, layout, b, s, h, d, seed, dev):
    """q, k, v, dO (B, H, S, D) fp32: q, k, v views of a (B, S, 3·H·D)
    projection ('qkv'), of one whose rows start a float late
    ('unaligned'), or contiguous ('dense'); dO a view of (B, S, H, D)
    memory, as the model's backward has it."""
    import torch

    def r(shape, i):
        return seeded_bf16(shape, seed + i, dev, torch.float32)
    if layout == "qkv":
        q, k, v = fb.heads(r((b, s, 3 * h * d), 0), h)
    elif layout == "unaligned":
        q, k, v = fb.heads(r((b, s, 3 * h * d + 1), 0)[..., 1:], h)
    else:
        q, k, v = (r((b, h, s, d), i) for i in range(3))
    return q, k, v, r((b, s, h, d), 5).transpose(1, 2)


def fp32_k5k6_edges(fb, dev):
    """The fp32 K5 and K6 (csrc/flash_bwd_simt.cu) at K5K6_FP32_EDGE_SHAPES
    against their plain versions, on lse and delta of the plain forward:
    each call run twice and bitwise equal, no copy, dq, dk and dv within
    K2_FP32_EDGE_REL of the call's largest plain gradient. Returns the
    worst error of K5 (dk, dv) and of K6 (dq)."""
    import torch

    worst = {"flash_bwd_dkdv": 0.0, "flash_bwd_dq": 0.0}
    for layout, (b, s, h, d) in K5K6_FP32_EDGE_SHAPES:
        tag = f"fp32 K5/K6 edge {layout} (B, S, H, D) = {(b, s, h, d)}"
        q, k, v, do = fp32_bwd_operands(fb, layout, b, s, h, d,
                                        7800 + s + d, dev)
        scale = d ** -0.5
        o, lse = fb.flash_fwd_reference(q, k, v, scale)
        delta = fb.flash_delta(o, do)
        copies, runs = fb.COPIES, []
        for _ in range(2):
            dq, dk, dv = fb.heads(torch.empty((b, s, 3 * h * d),
                                              device=dev), h)
            fb.flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv)
            fb.flash_bwd_dq(q, k, v, do, lse, delta, dq)
            runs.append((dq, dk, dv))
        want = (fb.flash_bwd_dq_reference(q, k, v, do, lse, delta, scale),
                *fb.flash_bwd_dkdv_reference(q, k, v, do, lse, delta, scale))
        torch.cuda.synchronize()
        check(fb.COPIES == copies, f"{tag}: {fb.COPIES - copies} copies")
        check(all(torch.equal(x, y) for x, y in zip(*runs)),
              f"{tag}: two runs on the same inputs differ")
        top = max(w.abs().max().item() for w in want)
        errs = [(g - w).abs().max().item() for g, w in zip(runs[0], want)]
        check(all(torch.isfinite(g).all().item() for g in runs[0])
              and max(errs) <= K2_FP32_EDGE_REL * top,
              f"{tag}: dq, dk, dv max abs err {errs} > {K2_FP32_EDGE_REL} x "
              f"{top}")
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs[0])
        worst["flash_bwd_dkdv"] = max(worst["flash_bwd_dkdv"], *errs[1:])
        log(f"[dtypes] {tag}: dq, dk, dv max abs err {errs!r} (largest "
            f"gradient {top!r}), bitwise repeat True")
        del q, k, v, do, o, lse, delta, runs, want
    return worst


def fp32_k4_edges(fb, dev) -> float:
    """The fp32 K4 (csrc/flash_fwd_simt.cu) at K4_FP32_EDGE_SHAPES against
    its plain version: each call run twice and bitwise equal, no copy, o
    and lse within K2_FP32_EDGE_REL of the plain version's largest
    magnitudes. Returns the worst o error."""
    import torch

    worst = 0.0
    for layout, (b, s, h, d) in K4_FP32_EDGE_SHAPES:
        tag = f"fp32 K4 edge {layout} (B, S, H, D) = {(b, s, h, d)}"
        q, k, v, _ = fp32_bwd_operands(fb, layout, b, s, h, d, 8100 + s + d,
                                       dev)
        copies = fb.COPIES
        (o, lse), (o2, lse2) = (fb.flash_fwd(q, k, v) for _ in range(2))
        want = fb.flash_fwd_reference(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        check(fb.COPIES == copies, f"{tag}: {fb.COPIES - copies} copies")
        check(torch.equal(o, o2) and torch.equal(lse, lse2),
              f"{tag}: two runs on the same inputs differ")
        errs = [((g - w).abs().max().item(), w.abs().max().item())
                for g, w in zip((o, lse), want)]
        check(torch.isfinite(o).all().item()
              and all(e <= K2_FP32_EDGE_REL * top for e, top in errs),
              f"{tag}: o, lse max abs err {errs} (of the largest plain "
              f"magnitude) > {K2_FP32_EDGE_REL} x it")
        worst = max(worst, errs[0][0])
        log(f"[dtypes] {tag}: o, lse max abs err (of the largest) {errs!r}, "
            f"bitwise repeat True")
        del q, k, v, o, lse, o2, lse2, want
    return worst


def hp_fp32_call(fa, fb, kernel, layout, shape, seed, dev):
    """(the call of fp32 K8, K10 or K12 on seeded operands laid out as
    `layout`, its plain version's call, whether `_stride_array` refuses
    the views): each call returns dq, dk, dv (B, H, S, D)."""
    import torch

    b, s, h, d = shape
    scale = d ** -0.5

    def r(shape, i):
        return seeded_bf16(shape, seed + i, dev, torch.float32)

    do = r((b, s, h * d), 9)
    if kernel in ("hp_bwd", "qkv_bwd"):
        qkv = r((b, s, 3 * h * d), 0)

        def plain():
            return fb.heads(fa.hp_bwd_reference(qkv, do, h, scale), h)
        if kernel == "hp_bwd":
            return lambda: fb.heads(fa.hp_bwd(qkv, do, h), h), plain, False
        qkv5 = qkv.view(b, s, 3, h, d)
        return (lambda: fb.heads(fa.qkv_bwd(qkv5, do).reshape(qkv.shape), h),
                plain, False)
    if layout == "dense":
        q, k, v = (r((b, h, s, d), i) for i in range(3))
    else:
        # rows two floats late (8-byte aligned: the kernels' 4-byte copies),
        # or of an odd row stride (refused: one copy)
        buf = r((b, s, 3 * h * d + (2 if layout == "late" else 1)), 0)
        q, k, v = fb.heads(buf[..., 2:] if layout == "late"
                           else buf[..., :-1], h)
    g = do.view(b, s, h, d).transpose(1, 2)
    refused = fa._stride_array((q, k, v, g), s, d) is None
    return (lambda: fa.fused_bwd(q, k, v, g),
            lambda: fa.fused_bwd_reference(q, k, v, g, scale), refused)


def fp32_hp_bwd_edges(fa, fb, dev):
    """The fp32 K8, K10 and K12 (csrc/hp_bwd_simt.cu) at HP_FP32_EDGE_SHAPES
    against their plain versions: each call run twice and bitwise equal,
    one copy a call exactly where `_stride_array` refuses the views, dq,
    dk and dv within K2_FP32_EDGE_REL of the call's largest plain
    gradient. Returns the worst error of each kernel."""
    import torch

    worst = {"fused_bwd": 0.0, "hp_bwd": 0.0, "qkv_bwd": 0.0}
    for kernel, layout, shape in HP_FP32_EDGE_SHAPES:
        tag = f"fp32 {kernel} edge {layout} (B, S, H, D) = {shape}"
        call, plain, refused = hp_fp32_call(fa, fb, kernel, layout, shape,
                                            8300 + shape[1] + shape[3], dev)
        copies = fb.COPIES
        runs = [call(), call()]
        want = plain()
        torch.cuda.synchronize()
        check(fb.COPIES - copies == 2 * refused,
              f"{tag}: {fb.COPIES - copies} copies, want {2 * refused}")
        check(all(torch.equal(x, y) for x, y in zip(*runs)),
              f"{tag}: two runs on the same inputs differ")
        top = max(w.abs().max().item() for w in want)
        errs = [(g - w).abs().max().item() for g, w in zip(runs[0], want)]
        check(all(torch.isfinite(g).all().item() for g in runs[0])
              and max(errs) <= K2_FP32_EDGE_REL * top,
              f"{tag}: dq, dk, dv max abs err {errs} > {K2_FP32_EDGE_REL} x "
              f"{top}")
        worst[kernel] = max(worst[kernel], *errs)
        log(f"[dtypes] {tag}: dq, dk, dv max abs err {errs!r} (largest "
            f"gradient {top!r}), copies {2 * refused}, bitwise repeat True")
        del call, plain, runs, want
    return worst


def trace_redesigned() -> None:
    """check_redesigned, in a process of its own (phase 17): a process's
    profiler sessions stop recording after a few dozen, and the main
    process's first sessions come after its trainers."""
    import torch

    sys.path.insert(0, REPO)
    from vision_transformers_torch_xla_tpu_torch.ops import (
        flash_attention as fa,
        flash_blocked as fb,
        mlp_fused as mf,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check_redesigned(fa, fb, mf, torch.device("cuda", 0))


def check_redesigned(fa, fb, mf, dev) -> None:
    """The redesigned kernels run alone: one call of the bf16, fp16 and
    fp32 K3, of the fp32 K2, of the fp32 K4, K5 and K6 and of the fp32 K8,
    K10 and K12, the calls of the fp32 K1, K9, K7 and K11 at
    REDESIGNED_FWD_D, those of the bf16 and fp16 K2 and the fp32 K8,
    K10 and K12 at head dims 192 and 256, and one call of the fp32 K2 at
    each of 192 and 256 launch (torch.profiler) their new kernels and no
    other of csrc/."""
    import torch

    for dt in (torch.bfloat16, torch.float16, torch.float32):
        b, s, o, k = MLP_MAIN_SHAPES[0] if dt != torch.float32 else \
            MLP_EXTRA_SHAPES[0]
        dy = seeded_bf16((b, s, o), 4500, dev, dt)
        w2 = seeded_bf16((o, k), 4501, dev, dt, 0.02)
        h = seeded_bf16((b, s, k), 4502, dev, dt)
        only_kernel(lambda: mf.fc2_bwd(dy, w2, h),
                    "fc2_bwd_simt_kernel(" if dt == torch.float32
                    else "fc2_bwd_tc_kernel<", f"redesigned K3 {dt}")
    b, s, h, d = BWD_MAIN_SHAPES[1]
    qkv = seeded_bf16((b, s, 3 * h * d), 4503, dev, torch.float32)
    do = seeded_bf16((b, s, h * d), 4504, dev, torch.float32)
    o, st = fa.attn_fwd(qkv, h, with_stats=True)
    only_kernel(lambda: fa.attn_bwd(qkv, do, o, st, h), "attn_bwd_kernel<",
                "redesigned fp32 K2")
    # the fp32 K1, K9, K7 and K11 (csrc/attn_fwd_simt.cuh) at
    # REDESIGNED_FWD_D: one session a wrapper, its calls at every head dim
    # together, launching attn_fwd_simt_kernel in its cast order alone
    fwd_calls = {"attn_fwd": [], "hp_fwd": [], "fused_fwd": [],
                 "qkv_fwd": []}
    for dw in REDESIGNED_FWD_D:
        x = seeded_bf16((8, 197, 3, h, dw), 4507 + dw, dev, torch.float32)
        flat = x.view(8, 197, 3 * h * dw)
        qkv_heads = [t.contiguous()
                     for t in x.permute(2, 0, 3, 1, 4).unbind(0)]
        fwd_calls["attn_fwd"].append(
            lambda flat=flat: fa.attn_fwd(flat, h, with_stats=True))
        fwd_calls["hp_fwd"].append(lambda flat=flat: fa.hp_fwd(flat, h))
        fwd_calls["fused_fwd"].append(
            lambda qkv_heads=qkv_heads: fa.fused_fwd(*qkv_heads))
        fwd_calls["qkv_fwd"].append(lambda x=x: fa.qkv_fwd(x))
    for name, calls in fwd_calls.items():
        order = "true" if name in ("fused_fwd", "qkv_fwd") else "false"
        kds = sorted({simt_kd(dw) for dw in REDESIGNED_FWD_D})
        only_kernels(lambda calls=calls: [c() for c in calls],
                     [f"attn_fwd_simt_kernel<{kd}, {order}, " for kd in kds],
                     f"redesigned fp32 {name}")
    # K5 and K6 at the 518-px model's sequence, on a qkv buffer's views
    q, k, v, do = fp32_bwd_operands(fb, "qkv", 2, LONG_MAIN_SHAPES[0][1], h,
                                    d, 4505, dev)
    o, lse = fb.flash_fwd_reference(q, k, v, d ** -0.5)
    delta = fb.flash_delta(o, do)
    dq, dk, dv = fb.heads(torch.empty((2, q.shape[2], 3 * h * d),
                                      device=dev), h)
    only_kernel(lambda: fb.flash_bwd_dkdv(q, k, v, do, lse, delta, dk, dv),
                "flash_bwd_dkdv_simt_kernel<64, 128, 2>(",
                "redesigned fp32 K5")
    only_kernel(lambda: fb.flash_bwd_dq(q, k, v, do, lse, delta, dq),
                "flash_bwd_dq_simt_kernel<64, 128, 2>(", "redesigned fp32 K6")
    only_kernel(lambda: fb.flash_fwd(q, k, v), "flash_fwd_simt_kernel<64>(",
                "redesigned fp32 K4")
    # K8, K10 and K12 at the op-level shape's sequence, in their layouts
    hp_kernels = ["hp_bwd_stats_simt_kernel<64, 128, 2>(",
                  "hp_bwd_dkdv_simt_kernel<64, 128, 2>(",
                  "hp_bwd_dq_sum_kernel("]
    for kernel, layout in (("fused_bwd", "dense"), ("hp_bwd", "qkv"),
                           ("qkv_bwd", "qkv")):
        call, _, _ = hp_fp32_call(fa, fb, kernel, layout, (8, 197, h, d),
                                  4506, dev)
        only_kernels(call, hp_kernels, f"redesigned fp32 {kernel}")
    # the wide tiles at head dims 192 and 256: K2 in bf16 and fp16 on
    # csrc/attn_bwd_tc.cu, the fp32 K8, K10 and K12 on csrc/hp_bwd_simt.cu
    for dt_name in ("bfloat16", "float16"):
        dt = getattr(torch, dt_name)
        calls, wants = [], []
        for dw in (192, 256):
            qkv = seeded_bf16((2, 197, 3 * h * dw), 4520 + dw, dev, dt)
            do = seeded_bf16((2, 197, h * dw), 4521 + dw, dev, dt)
            o, st = fa.attn_fwd(qkv, h, with_stats=True)
            calls.append(lambda qkv=qkv, do=do, o=o, st=st:
                         fa.attn_bwd(qkv, do, o, st, h))
            wants += wide_kernel_names("attn_bwd", dt_name, dw)
        only_kernels(lambda calls=calls: [c() for c in calls],
                     sorted(set(wants)), f"redesigned wide {dt_name} K2")
    for kernel, layout in (("fused_bwd", "dense"), ("hp_bwd", "qkv"),
                           ("qkv_bwd", "qkv")):
        calls, wants = [], []
        for dw in (192, 256):
            call, _, _ = hp_fp32_call(fa, fb, kernel, layout,
                                      (2, 197, h, dw), 4530 + dw, dev)
            calls.append(call)
            wants += wide_kernel_names(kernel, "float32", dw)
        only_kernels(lambda calls=calls: [c() for c in calls],
                     sorted(set(wants)), f"redesigned wide fp32 {kernel}")
    # the fp32 K2 at 192 and 256 on csrc/attn_bwd_simt.cu, each alone
    for dw in (192, 256):
        qkv = seeded_bf16((2, 197, 3 * h * dw), 4540 + dw, dev,
                          torch.float32)
        do = seeded_bf16((2, 197, h * dw), 4541 + dw, dev, torch.float32)
        o, st = fa.attn_fwd(qkv, h, with_stats=True)
        only_kernels(lambda qkv=qkv, do=do, o=o, st=st:
                     fa.attn_bwd(qkv, do, o, st, h),
                     wide_kernel_names("attn_bwd", "float32", dw),
                     f"redesigned wide fp32 K2 D={dw}")


def only_kernels(fn, wants, tag) -> None:
    """Of the port's kernels (csrc/'s), fn launches exactly the kernels
    that `wants` names (substrings of their demangled names, spaces
    ignored), each of them. A session that records a kernel of csrc/ that
    `wants` does not name fails the check at once; one that misses some of
    `wants` and records nothing else of csrc/ (a session has been seen to
    drop every launch of one kernel, in a run whose other sessions recorded
    theirs) says nothing of what fn launched, and is made again, up to
    TRACE_TRIES sessions in all."""
    wants = [w.replace(" ", "") for w in wants]
    for attempt in range(1, TRACE_TRIES + 1):
        names = launched_kernels(fn)
        ours = sorted(n.replace(" ", "") for n in names
                      if "anonymous namespace" in n)
        log(f"[{tag}] the call launched {sorted(names)}")
        check(all(any(w in n for w in wants) for n in ours),
              f"{tag}: the call launched {ours} of csrc/, want {wants}")
        missed = [w for w in wants if not any(w in n for n in ours)]
        if not missed:
            return
        log(f"[trace] profiler session {attempt} of {TRACE_TRIES} missed "
            f"{missed}")
    check(False, f"{tag}: the call launched {ours} of csrc/, want {wants}")


def wide_route(dt_name: str, d: int, name: str = "") -> str:
    """The route of K1, K2, K9, K7-K12 and K4-K6 at head dim d > 128: the
    wide tensor-core tiles up to 256 in bf16 and fp16 (in place at a
    multiple of 8), else the CUDA cores."""
    if dt_name == "float32" or d > 256:
        return "cuda_cores"
    return "tensor_cores" if d % 8 == 0 else "tensor_cores_copy"


def simt_kd(d: int) -> int:
    """The compile-time head dim of csrc/attn_fwd_simt.cuh's kernel that
    takes head dim d (<= 256)."""
    return next(kd for kd in (32, 64, 128, 192, 256) if d <= kd)


def wide_kernel_names(name: str, dt_name: str, d: int):
    """The csrc/ kernels one call of kernel `name` launches at head dim
    d > 128 in dtype dt_name, as the routes decide (the fp32 K1, K9, K7 and
    K11 on their stored path: the shapes traced and timed have S <= 384)."""
    t = {"bfloat16": "__nv_bfloat16", "float16": "__half",
         "float32": "float"}[dt_name]
    tc = wide_route(dt_name, d, name) != "cuda_cores"
    kd = 192 if d <= 192 else 256
    if name.startswith("flash"):
        # csrc/flash_fwd.cu's and flash_bwd.cu's take tensor maps (K6's
        # wide tiles a kernel of their own); the fp32 K4, K5 and K6 to 256
        # run on the wide register tiles of csrc/flash_fwd_simt.cu and
        # flash_bwd_simt.cu; csrc/flash_blocked.cu's run-time head dim
        # (every dtype past 256) takes pointers
        kernel = "flash_bwd_dq_tc_wide" if name == "flash_bwd_dq" else name
        if tc:
            return [f"{kernel}_kernel<{t},{kd}>(CUtensorMap"]
        if dt_name == "float32" and d <= 256:
            return [f"{name}_wide_simt_kernel<{kd}>"]
        return [f"{name}_wide_kernel<{t}>"]
    if name == "attn_bwd":
        # csrc/attn_bwd_tc.cu's prep, wide dk/dv and dq, and bias sum;
        # in fp32 to 256 csrc/attn_bwd_simt.cu's rows, dk/dv, dq sum and
        # bias sum
        if tc:
            return [f"attn_bwd_tc_prep_kernel<{t}>",
                    f"attn_bwd_tc_dkdv_wide_kernel<{t},{kd}>",
                    f"attn_bwd_tc_dq_wide_kernel<{t},{kd}>",
                    "attn_bwd_tc_bias_kernel("]
        if dt_name == "float32" and d <= 256:
            return ["attn_bwd_rows_simt_kernel(",
                    f"attn_bwd_dkdv_wide_simt_kernel<{kd}>",
                    f"attn_bwd_dq_sum_simt_kernel<{kd}>",
                    "attn_bwd_bias_simt_kernel("]
        return [f"attn_bwd_wide_kernel<{t}>"]
    if name in ("attn_fwd", "hp_fwd", "fused_fwd", "qkv_fwd"):
        k7 = "true" if name in ("fused_fwd", "qkv_fwd") else "false"
        if tc:
            return [f"attn_fwd_tc_kernel<{t},{kd},{k7}>"]
        if dt_name == "float32" and d <= 256:  # csrc/attn_fwd_simt.cuh
            return [f"attn_fwd_simt_kernel<{kd},{k7},true>"]
        return [f"attn_fwd_kernel<{t},0>" if k7 == "false"
                else f"fused_attn_fwd_kernel<{t},0>"]
    if tc:
        return [f"hp_bwd_tc_dq_kernel<{t},{kd}>",
                f"hp_bwd_tc_dkdv_kernel<{t},{kd}>"]
    if dt_name == "float32" and d <= 256:  # csrc/hp_bwd_simt.cu
        return [f"hp_bwd_stats_wide_simt_kernel<{kd}>",
                f"hp_bwd_dkdv_wide_simt_kernel<{kd}>", "hp_bwd_dq_sum_kernel("]
    return [f"hp_bwd_dq_kernel<{t},0>", f"hp_bwd_dkdv_kernel<{t},0>"]


def drive_wide_heads(counts, fa, dev, dt):
    """Forward and backward through every entry point that reaches a
    kernel at head dims over 128 (WIDE_QKV_SHAPES, WIDE_LONG_SHAPES) in
    dtype `dt`; returns the launches (counts() after a reset)."""
    import torch

    from vision_transformers_torch_xla_tpu_torch.ops import (
        multi_head_attention,
    )

    def leaf(shape, seed, scale=1.0):
        return seeded_bf16(shape, seed, dev, dt, scale).requires_grad_()

    def backward(o, seed):
        o.backward(seeded_bf16(tuple(o.shape), seed, dev, dt))

    counts(reset=True)
    for b, s, h, d in WIDE_QKV_SHAPES:
        seed = 8000 + s + d
        # K1, K2: the fused projection + attention
        backward(fa.qkv_proj_attention(
            leaf((b, s, h * d), seed), leaf((h * d, 3 * h * d), seed + 1,
                                            0.05),
            leaf((3 * h * d,), seed + 2, 0.05), h), seed + 3)
        # K9, K10
        backward(fa.fused_attention_qkv_cols(leaf((b, s, 3 * h * d),
                                                  seed + 4), h), seed + 5)
    for b, s, h, d in WIDE_LONG_SHAPES:
        seed = 8200 + d
        backward(fa.fused_attention_qkv_cols(leaf((b, s, 3 * h * d), seed),
                                             h), seed + 1)
    b, s, h, d = WIDE_QKV_SHAPES[0]
    backward(multi_head_attention(*(leaf((b, h, s, d), 8300 + i)
                                    for i in range(3)), use_pallas=True),
             8303)
    backward(fa.fused_attention_qkv(leaf((b, s, 3, h, d), 8310)), 8311)
    torch.cuda.synchronize()
    return counts()


def wide_routes_hold(fa, fb, name, shape, dt, dt_name) -> None:
    """The route functions answer as the wide-head rule says for `name`."""
    import torch

    b, s, h, d = shape
    qkv = torch.empty((b, s, 3 * h * d), dtype=dt, device="cuda")
    do = torch.empty((b, s, h * d), dtype=dt, device="cuda")
    q, k, v = fb.heads(qkv, h)
    if name.startswith("flash"):
        got, want = fb.kernel_route(name, q, k, v), wide_route(dt_name, d,
                                                               name)
    elif name == "attn_bwd":
        got, want = (fa.attn_kernel_route(qkv, h, do, do),
                     wide_route(dt_name, d, name))
    elif name in ("attn_fwd", "hp_fwd"):
        got, want = fa.attn_kernel_route(qkv, h), wide_route(dt_name, d)
    elif name in ("fused_fwd", "qkv_fwd"):
        got, want = fa.fused_kernel_route(q, k, v), wide_route(dt_name, d)
    else:
        got, want = (fa.bwd_kernel_route(q, k, v, fa._head_major(do, h)),
                     wide_route(dt_name, d))
    check(got == want, f"wide heads {dt_name} {name} {shape}: route {got!r}, "
          f"want {want!r}")


def phase_wide_heads(counts, fa, fb, mf, dev):
    """Head dims over 128 on every route (F8): the entry points driven once
    per dtype (drive_wide_heads), which must launch each kernel as often as
    the shapes say; each kernel's route answered as the rule says; one call
    of each at D 256 (and past 256 in bf16), traced together per dtype,
    launching exactly the csrc/ kernels their routes name (torch.profiler);
    each held against its plain
    version at every wide shape, and timed at WIDE_TIMED (K4-K6
    WIDE_LONG_TIMED) beside its plain version and SDPA. Returns the
    launches per dtype, the rows and the worst errors per (dtype,
    kernel)."""
    import gc

    import torch

    launches, rows, worst = {}, {}, {}
    n_qkv, n_long = len(WIDE_QKV_SHAPES), len(WIDE_LONG_SHAPES)
    want = only(ATTN_FWD_LAUNCHES=n_qkv, ATTN_BWD_LAUNCHES=n_qkv,
                HP_FWD_LAUNCHES=n_qkv, HP_BWD_LAUNCHES=n_qkv,
                FLASH_FWD_LAUNCHES=n_long, FLASH_BWD_DKDV_LAUNCHES=n_long,
                FLASH_BWD_DQ_LAUNCHES=n_long, FUSED_FWD_LAUNCHES=1,
                FUSED_BWD_LAUNCHES=1, QKV_FWD_LAUNCHES=1,
                QKV_BWD_LAUNCHES=1)
    for dt_name in WIDE_DTYPES:
        dt = getattr(torch, dt_name)
        launches[dt_name] = drive_wide_heads(counts, fa, dev, dt)
        log(f"[wide heads] {dt_name}: the entry points launched "
            f"{launches[dt_name]}")
        check(launches[dt_name] == want, f"wide heads {dt_name}: the entry "
              f"points launched {launches[dt_name]}, want {want}")
        peak = DTYPE_PEAK[dt_name][0]
        # one profiler session per dtype (a process's sessions stop
        # recording after a few dozen): each kernel's call at D 256 (and
        # past 256 in bf16) together must launch exactly the csrc/ kernels
        # their routes name
        traced, names = [], set()
        for name in WIDE_KERNELS:
            shapes = WIDE_LONG_SHAPES if name.startswith("flash") \
                else WIDE_QKV_SHAPES
            for shape in shapes:
                d = shape[3]
                wide_routes_hold(fa, fb, name, shape, dt, dt_name)
                kernel, plain, _, _, _, kinds, _ = \
                    dtype_case(fa, fb, mf, name, shape, dt, dev)
                tag = f"wide heads {dt_name} {name} {shape}"
                if shape == shapes[0] or (d > 256 and dt_name == "bfloat16"):
                    traced.append(kernel)
                    names.update(wide_kernel_names(name, dt_name, d))
                got, want_out = kernel(), plain()
                torch.cuda.synchronize()
                errs = []
                for i, (g, w, kind) in enumerate(zip(got, want_out, kinds)):
                    check(g.shape == w.shape and g.dtype == w.dtype
                          and torch.isfinite(g.float()).all().item(),
                          f"{tag} output {i}: {tuple(g.shape)} {g.dtype} or "
                          f"not finite")
                    err = (g.float() - w.float()).abs().max().item()
                    ref = w.float().abs().max().item()
                    limit = {"rel": WIDE_REL[dt_name] * ref,
                             "fp32": FP32_OUT_REL[dt_name] * ref,
                             "lse": LSE_ATOL}[kind]
                    check(err <= limit, f"{tag} output {i}: max abs err "
                          f"{err} > {limit}")
                    errs.append(err)
                    if kind == "rel":
                        worst[(dt_name, name)] = max(
                            worst.get((dt_name, name), 0.0), err)
                log(f"[wide heads] {dt_name} {name} {shape}: max abs errs "
                    f"{errs!r}")
                del got, want_out, plain
            timed = WIDE_LONG_TIMED if name.startswith("flash") \
                else WIDE_TIMED
            kernel, plain, library, flops, nbytes, _, _ = \
                dtype_case(fa, fb, mf, name, timed, dt, dev)
            row = {"shape": timed, "ms": cuda_ms(kernel),
                   "plain_ms": cuda_ms(plain), "library_ms": library()}
            row["bound_ms"], row["bound_by"] = bound(flops, nbytes, peak)
            rows[(dt_name, name)] = row
            log(f"[wide heads] {dt_name} {name} timed on {nvidia_smi()}: "
                + " ".join(f"{k}={v!r}" for k, v in row.items()))
            if dt_name == "float32" and name in REPLACED_WIDE_FP32_MS:
                log(f"[wide heads] float32 {name} {timed}: kernel / plain / "
                    f"SDPA {row['ms']!r} / {row['plain_ms']!r} / "
                    f"{row['library_ms']!r} ms (the loops it replaced: "
                    f"{REPLACED_WIDE_FP32_MS[name]} device ms)")
            if (dt_name, name) in REPLACED_WIDE_BWD_MS:
                log(f"[wide heads] {dt_name} {name} {timed}: kernel / plain "
                    f"/ SDPA {row['ms']!r} / {row['plain_ms']!r} / "
                    f"{row['library_ms']!r} ms (the loops it replaced: "
                    f"{REPLACED_WIDE_BWD_MS[(dt_name, name)]} ms)")
            del kernel, plain, library
            gc.collect()
        # twice: a session can miss the first launches it should record
        only_kernels(lambda: [fn() for fn in traced + traced], sorted(names),
                     f"wide heads {dt_name}")
        del traced
        t_k2 = time.perf_counter()
        worst[(dt_name, "attn_bwd")] = max(
            worst[(dt_name, "attn_bwd")],
            tc_k2_wide_edges(fa, fb, dev, dt_name))
        log(f"[time] the {dt_name} K2 wide edges took "
            f"{time.perf_counter() - t_k2:.1f} s")
        torch.cuda.empty_cache()
    return launches, rows, worst


def tc_k2_wide_edges(fa, fb, dev, dt_name) -> float:
    """K2 on the wide tensor-core tiles (csrc/attn_bwd_tc.cu) in bf16 and
    fp16, on the fp32 register tiles (csrc/attn_bwd_simt.cu) in fp32, in
    dtype dt_name at K2_WIDE_EDGE_SHAPES against its plain version, on o
    and the row stats of K1: the route wide_route's (one `padded_copy` a
    call exactly where it says so), each call run twice and bitwise equal,
    dqkv within WIDE_REL and the bias partials within DBIAS_REL_ATOL of
    their largest magnitude (fp32: both within K2_FP32_EDGE_REL). Returns
    the worst dqkv error."""
    import torch

    dt = getattr(torch, dt_name)
    limits = (K2_FP32_EDGE_REL, K2_FP32_EDGE_REL) if dt_name == "float32" \
        else (WIDE_REL[dt_name], DBIAS_REL_ATOL)
    worst = 0.0
    for b, s, h, d in K2_WIDE_EDGE_SHAPES:
        tag = f"{dt_name} K2 wide edge (B, S, H, D) = {(b, s, h, d)}"
        qkv = seeded_bf16((b, s, 3 * h * d), 7700 + s + d, dev, dt)
        do = seeded_bf16((b, s, h * d), 7800 + s + d, dev, dt)
        route = fa.attn_kernel_route(qkv, h, do, do)
        check(route == wide_route(dt_name, d, "attn_bwd"),
              f"{tag}: route {route}")
        o, st = fa.attn_fwd(qkv, h, with_stats=True)
        copies = fb.COPIES
        got = fa.attn_bwd(qkv, do, o, st, h)
        route_copies(fa, fb, copies, qkv, h, do, o)
        again = fa.attn_bwd(qkv, do, o, st, h)
        want = fa.attn_bwd_reference(qkv, do, o, st, h, d ** -0.5)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{tag}: two runs on the same inputs differ")
        errs = []
        for what, g, w, rel in zip(("dqkv", "bias partials"), got, want,
                                   limits):
            err = (g.float() - w.float()).abs().max().item()
            ref = w.float().abs().max().item()
            check(torch.isfinite(g.float()).all().item()
                  and err <= rel * ref,
                  f"{tag}: {what} max abs err {err} > {rel} x {ref}")
            errs.append(err)
        worst = max(worst, errs[0])
        log(f"[wide heads] {tag}: route {route}, dqkv, bias max abs err "
            f"{errs!r}, bitwise repeat True")
        del qkv, do, o, st, got, again, want
    return worst


def phase_mlp_kernel(mf, dev):
    """K3 against its plain version on seeded bf16 dy, fc2 weight and h."""
    import torch

    results = {}
    worst = 0.0
    for shape in MLP_MAIN_SHAPES + MLP_EXTRA_SHAPES:
        b, s, o, k = shape
        seed = 4000 + b * s + o + k
        dy = seeded_bf16((b, s, o), seed, dev)
        # fc2's weight at its init scale, h at a pre-activation's
        w2 = (seeded_bf16((o, k), seed + 1, dev).float() * 0.02).bfloat16()
        h = seeded_bf16((b, s, k), seed + 2, dev)
        got = mf.fc2_bwd(dy, w2, h)
        again = mf.fc2_bwd(dy, w2, h)
        want = mf.fc2_bwd_reference(dy, w2, h)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{shape}: two runs of K3 on the same inputs differ")
        row = {"bitwise_repeat": True}
        for name, g, r, rel in zip(("dh", "a", "db1"), got, want,
                                   (DH_REL_ATOL, DH_REL_ATOL, DB1_REL_ATOL)):
            check(g.shape == r.shape and g.dtype == r.dtype
                  and torch.isfinite(g.float()).all().item(),
                  f"{shape} {name}: {tuple(g.shape)} {g.dtype} or not finite")
            err = (g.float() - r.float()).abs().max().item()
            ref_max = r.float().abs().max().item()
            check(err <= rel * ref_max,
                  f"{shape} {name}: max abs err {err} > {rel} x {ref_max}")
            row[f"{name}_max_abs_err"] = err
            row[f"{name}_max_abs"] = ref_max
        worst = max(worst, row["dh_max_abs_err"], row["a_max_abs_err"])
        if shape in MLP_MAIN_SHAPES:
            row["ms"] = cuda_ms(lambda: mf.fc2_bwd(dy, w2, h))
            row["plain_ms"] = cuda_ms(lambda: mf.fc2_bwd_reference(dy, w2, h))
            row["unfused_ms"] = cuda_ms(lambda: unfused_mlp_bwd(dy, w2, h))
            # dy, w2, h read; dh, a (bf16) and db1 (fp32) written; dy·w2
            m = b * s
            row["bound_ms"], row["bound_by"] = bound(
                2 * m * o * k, 2 * (m * o + o * k + 3 * m * k) + 4 * k)
        results[shape] = row
        log(f"[mlp kernel] B={b} S={s} O={o} K={k}: "
            + " ".join(f"{k_}={v!r}" for k_, v in row.items()))
    return results, worst


class check_fc2_bwd:
    """Within it, each call of ops/mlp_fused.py's wrapper launches the
    kernel, then runs the plain version on the same inputs (the model's own
    data); `worst` keeps each output's largest error over the plain
    version's max |.|."""

    def __init__(self, mf):
        self.mf, self.kernel, self.worst = mf, mf.fc2_bwd, {}

    def __enter__(self):
        def checked(dy, w2, h):
            got = self.kernel(dy, w2, h)
            for name, g, r in zip(("dh", "a", "db1"), got,
                                  self.mf.fc2_bwd_reference(dy, w2, h)):
                err = (g.float() - r.float()).abs().max().item() / \
                    r.float().abs().max().item()
                self.worst[name] = max(self.worst.get(name, 0.0), err)
            return got

        self.mf.fc2_bwd = checked
        return self

    def __exit__(self, *exc):
        self.mf.fc2_bwd = self.kernel


def phase_hp_kernel(counts, fa, dev):
    """K9 and K10 through fused_attention_qkv_cols at S <= 1024, held
    against their plain versions; returns the route's launches, the
    results and the worst errors."""
    import torch

    from vision_transformers_torch_xla_tpu_torch.ops.flash_blocked import (
        heads,
    )

    shapes = HP_MAIN_SHAPES + HP_EXTRA_SHAPES
    runs = {}
    counts(reset=True)
    for shape in shapes:
        b, s, h, d = shape
        seed = 5000 + b * s + h * d
        qkv = seeded_bf16((b, s, 3 * h * d), seed, dev).requires_grad_()
        do = seeded_bf16((b, s, h * d), seed + 1, dev)
        o = fa.fused_attention_qkv_cols(qkv, h)
        o.backward(do)
        runs[shape] = (qkv.detach(), do, o.detach(), qkv.grad)
    torch.cuda.synchronize()
    launches = counts()

    results = {}
    worst = {"hp_fwd": 0.0, "hp_bwd": 0.0}
    for shape, (qkv, do, o, dqkv) in runs.items():
        b, s, h, d = shape
        scale = d ** -0.5
        o_r = fa.attn_fwd_reference(qkv, h, scale)[0]
        dqkv_r = fa.hp_bwd_reference(qkv, do, h, scale)
        torch.cuda.synchronize()
        check(o.shape == o_r.shape and dqkv.shape == qkv.shape
              and torch.isfinite(o.float()).all().item()
              and torch.isfinite(dqkv.float()).all().item(),
              f"{shape}: shapes {tuple(o.shape)}, {tuple(dqkv.shape)} or "
              f"not finite")
        o_err = (o.float() - o_r.float()).abs().max().item()
        g_err = (dqkv.float() - dqkv_r.float()).abs().max().item()
        g_ref = dqkv_r.float().abs().max().item()
        check(o_err <= O_ATOL, f"{shape}: o max abs err {o_err} > {O_ATOL}")
        check(g_err <= DQKV_REL_ATOL * g_ref,
              f"{shape}: dqkv max abs err {g_err} > {DQKV_REL_ATOL} x {g_ref}")
        worst["hp_fwd"] = max(worst["hp_fwd"], o_err)
        worst["hp_bwd"] = max(worst["hp_bwd"], g_err)
        row = {"o_max_abs_err": o_err, "dqkv_max_abs_err": g_err,
               "dqkv_max_abs": g_ref}
        if shape in HP_MAIN_SHAPES:
            row["hp_fwd_ms"] = cuda_ms(lambda: fa.hp_fwd(qkv, h, scale))
            row["hp_fwd_plain_ms"] = cuda_ms(
                lambda: fa.attn_fwd_reference(qkv, h, scale))
            row["hp_fwd_library_ms"] = sdpa_ms(*heads(qkv, h))
            row["hp_bwd_ms"] = cuda_ms(lambda: fa.hp_bwd(qkv, do, h, scale))
            row["hp_bwd_plain_ms"] = cuda_ms(
                lambda: fa.hp_bwd_reference(qkv, do, h, scale))
            row["hp_bwd_library_ms"] = sdpa_ms(
                *heads(qkv, h), do.view(b, s, h, d).transpose(1, 2))
            # K9: qkv read, o written; q·kᵀ and p·v. K10: qkv and dO read,
            # dqkv written; q·kᵀ, dO·vᵀ, pᵀ·dO, ds·k, dsᵀ·q
            sq, n_qkv, n_o = b * h * s * s * d, b * s * 3 * h * d, b * s * h * d
            row["hp_fwd_bound_ms"], row["hp_fwd_bound_by"] = bound(
                4 * sq, 2 * (n_qkv + n_o))
            row["hp_bwd_bound_ms"], row["hp_bwd_bound_by"] = bound(
                10 * sq, 2 * (2 * n_qkv + n_o))
        results[shape] = row
        log(f"[hp kernel] B={b} S={s} H={h} D={d}: "
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    from vision_transformers_torch_xla_tpu_torch.ops import (
        flash_blocked as fb,
    )

    edge = bwd_edges(fa, fb, dev, ("hp_bwd",))
    worst["hp_bwd"] = max(worst["hp_bwd"], edge["hp_bwd"])
    return launches, results, worst


def bwd_edges(fa, fb, dev, names):
    """The tensor-core K8, K10 and K12 (the wrappers `names` picks among
    fused_bwd, hp_bwd and qkv_bwd) in bf16 and fp16 at TC_EDGE_SHAPES:
    the gradients against fused_bwd_reference within DQKV_REL_ATOL of its
    largest magnitude, each call run twice and bitwise equal (no float
    atomics), one copy exactly where bwd_kernel_route says, and no call
    reaching csrc/hp_bwd.cu (the fp32 kernels). Returns the worst bf16
    error per name."""
    import torch

    def refuse():
        raise RuntimeError("a bf16/fp16 backward reached csrc/hp_bwd.cu")

    worst = dict.fromkeys(names, 0.0)
    cuda_cores, fa.build_hp_bwd_kernels = fa.build_hp_bwd_kernels, refuse
    try:
        for dt_name in EDGE_DTYPES:
            dt = getattr(torch, dt_name)
            edge = dict.fromkeys(names, 0.0)
            for b, s, h, d in TC_EDGE_SHAPES:
                x = seeded_bf16((b, s, 3, h, d), 6700 + s + d, dev, dt)
                do_s = seeded_bf16((b, s, h * d), 6800 + s + d, dev, dt)
                heads5 = x.permute(2, 0, 3, 1, 4).unbind(0)
                dob = do_s.view(b, s, h, d).transpose(1, 2)
                q, k, v, do = (t.contiguous() for t in (*heads5, dob))
                want = torch.stack(fa.fused_bwd_reference(
                    q, k, v, do, d ** -0.5)).float()
                runs = {
                    "fused_bwd": (lambda: torch.stack(fa.fused_bwd(
                        q, k, v, do)), (q, k, v, do)),
                    "qkv_bwd": (lambda: fa.qkv_bwd(x, do_s).permute(
                        2, 0, 3, 1, 4), (*heads5, dob)),
                    "hp_bwd": (lambda: fa.hp_bwd(
                        x.view(b, s, 3 * h * d), do_s, h).view(
                        x.shape).permute(2, 0, 3, 1, 4), (*heads5, dob))}
                for name in names:
                    run, ins = runs[name]
                    copies = fb.COPIES
                    g, g2 = run(), run()
                    torch.cuda.synchronize()
                    tag = f"{name} {dt_name} {(b, s, h, d)}"
                    route = fa.bwd_kernel_route(*ins)
                    check(route != "cuda_cores", f"{tag}: route {route}")
                    want_copies = 2 * int(route == "tensor_cores_copy")
                    check(fb.COPIES - copies == want_copies,
                          f"{tag}: {fb.COPIES - copies} copies in two "
                          f"calls, the route says {want_copies}")
                    check(g.shape == want.shape and g.dtype == dt
                          and torch.isfinite(g.float()).all().item(),
                          f"{tag}: {tuple(g.shape)} {g.dtype} or not finite")
                    check(torch.equal(g, g2),
                          f"{tag}: two runs on the same inputs differ")
                    err = (g.float() - want).abs().max().item()
                    ref = want.abs().max().item()
                    check(err <= DQKV_REL_ATOL * ref,
                          f"{tag}: grads max abs err {err} > "
                          f"{DQKV_REL_ATOL} x {ref}")
                    edge[name] = max(edge[name], err)
            if dt_name == "bfloat16":
                worst = edge
            log(f"[bwd edges] tensor-core {', '.join(names)} in {dt_name} "
                f"at {len(TC_EDGE_SHAPES)} edge shapes (csrc/hp_bwd_tc.cu, "
                f"bitwise repeat, copies as the route says): grads max abs "
                f"err {edge!r}")
    finally:
        fa.build_hp_bwd_kernels = cuda_cores
    return worst


def phase_fused_kernel(counts, fa, dev):
    """K7 and K8 through multi_head_attention(use_pallas=True), K11 and K12
    through fused_attention_qkv, held against their plain versions; the
    tensor-core K7 and K11 at TC_EDGE_SHAPES in bf16 and fp16; then both
    entry points at S = 1100, which must launch nothing. Returns the route's
    launches, the results and the worst bf16 errors."""
    import torch

    from vision_transformers_torch_xla_tpu_torch.ops import (
        flash_blocked as fb,
        multi_head_attention,
    )

    def leaf(shape, seed):
        return seeded_bf16(shape, seed, dev).requires_grad_()

    def heads5(qkv):   # (B, H, S, D) views of a (B, S, 3, H, D) buffer
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)

    shapes = FUSED_MAIN_SHAPES + FUSED_EXTRA_SHAPES
    mha, qkv_runs = {}, {}
    counts(reset=True)
    for shape in shapes:
        b, s, h, d = shape
        seed = 6000 + b * s + h * d
        q, k, v = (leaf((b, h, s, d), seed + i) for i in range(3))
        do = seeded_bf16((b, h, s, d), seed + 3, dev)
        o = multi_head_attention(q, k, v, use_pallas=True)
        o.backward(do)
        mha[shape] = ((q.detach(), k.detach(), v.detach(), do), o.detach(),
                      (q.grad, k.grad, v.grad))
        qkv = leaf((b, s, 3, h, d), seed + 4)
        do_s = seeded_bf16((b, s, h * d), seed + 5, dev)
        o = fa.fused_attention_qkv(qkv)
        o.backward(do_s)
        x = qkv.detach()
        qkv_runs[shape] = (
            (*heads5(x), do_s.view(b, s, h, d).transpose(1, 2)),
            o.detach().view(b, s, h, d).transpose(1, 2), heads5(qkv.grad),
            x, do_s)
    # the (B, H, S, D) views of one qkv buffer, read in place
    b, s, h, d = FUSED_VIEW_SHAPE
    qkv = leaf((b, s, 3, h, d), 6900)
    do = seeded_bf16((b, h, s, d), 6901, dev)
    o = multi_head_attention(*heads5(qkv), use_pallas=True)
    o.backward(do)
    view_run = ((*heads5(qkv.detach()), do), o.detach(), heads5(qkv.grad))
    torch.cuda.synchronize()
    launches = counts()

    # the tensor-core K7 and K11 at their edges (TC_EDGE_SHAPES) in bf16 and
    # fp16: o against the plain version, one copy exactly where
    # fused_kernel_route says
    worst = dict.fromkeys(("fused_fwd", "fused_bwd", "qkv_fwd", "qkv_bwd"),
                          0.0)
    for dt_name in EDGE_DTYPES:
        dt = getattr(torch, dt_name)
        edge = dict.fromkeys(("fused_fwd", "qkv_fwd"), 0.0)
        for b, s, h, d in TC_EDGE_SHAPES:
            x = seeded_bf16((b, s, 3, h, d), 6500 + s + d, dev, dt)
            q, k, v = (t.contiguous() for t in heads5(x))
            o_r = fa.fused_fwd_reference(q, k, v, d ** -0.5)
            runs = (("fused_fwd", lambda: fa.fused_fwd(q, k, v), (q, k, v)),
                    ("qkv_fwd", lambda: fa.qkv_fwd(x).view(
                        b, s, h, d).transpose(1, 2), heads5(x)))
            for name, run, ins in runs:
                copies = fb.COPIES
                o = run()
                torch.cuda.synchronize()
                want = int(fa.fused_kernel_route(*ins) == "tensor_cores_copy")
                tag = f"{name} {dt_name} {(b, s, h, d)}"
                check(fb.COPIES - copies == want,
                      f"{tag}: {fb.COPIES - copies} copies, the route says "
                      f"{want}")
                check(o.shape == o_r.shape
                      and torch.isfinite(o.float()).all().item(),
                      f"{tag}: shape {tuple(o.shape)} or not finite")
                err = (o.float() - o_r.float()).abs().max().item()
                check(err <= O_ATOL, f"{tag}: o max abs err {err} > {O_ATOL}")
                edge[name] = max(edge[name], err)
        if dt_name == "bfloat16":
            worst.update(edge)
        log(f"[fused kernel] tensor-core K7, K11 in {dt_name} at "
            f"{len(TC_EDGE_SHAPES)} edge shapes (copies as the route says): "
            f"o max abs err {edge!r}")
    worst.update(bwd_edges(fa, fb, dev, ("fused_bwd", "qkv_bwd")))

    def held(tag, shape, run):
        """o and (dq, dk, dv) against the plain versions; returns the
        errors."""
        (q, k, v, do), o, grads = run
        scale = q.shape[-1] ** -0.5
        o_r = fa.fused_fwd_reference(q, k, v, scale)
        g = torch.stack(grads).float()
        g_r = torch.stack(fa.fused_bwd_reference(q, k, v, do, scale)).float()
        torch.cuda.synchronize()
        check(o.shape == o_r.shape and g.shape == g_r.shape
              and torch.isfinite(o.float()).all().item()
              and torch.isfinite(g).all().item(),
              f"{tag} {shape}: shapes {tuple(o.shape)}, {tuple(g.shape)} or "
              f"not finite")
        o_err = (o.float() - o_r.float()).abs().max().item()
        g_err = (g - g_r).abs().max().item()
        g_ref = g_r.abs().max().item()
        check(o_err <= O_ATOL,
              f"{tag} {shape}: o max abs err {o_err} > {O_ATOL}")
        check(g_err <= DQKV_REL_ATOL * g_ref,
              f"{tag} {shape}: grads max abs err {g_err} > {DQKV_REL_ATOL} "
              f"x {g_ref}")
        return o_err, g_err, g_ref

    results = {}
    for shape in shapes:
        b, s, h, d = shape
        row = {}
        for tag, run in (("fused", mha[shape]), ("qkv", qkv_runs[shape][:3])):
            o_err, g_err, g_ref = held(tag, shape, run)
            worst[f"{tag}_fwd"] = max(worst[f"{tag}_fwd"], o_err)
            worst[f"{tag}_bwd"] = max(worst[f"{tag}_bwd"], g_err)
            row.update({f"{tag}_o_max_abs_err": o_err,
                        f"{tag}_grads_max_abs_err": g_err,
                        f"{tag}_grads_max_abs": g_ref})
        if shape in FUSED_MAIN_SHAPES:
            scale = d ** -0.5
            (q, k, v, do), _, _ = mha[shape]
            (qv, kv, vv, dov), _, _, qkv, do_s = qkv_runs[shape]

            def qkv_fwd_plain():
                o = fa.fused_fwd_reference(qv, kv, vv, scale)
                return o.transpose(1, 2).reshape(b, s, h * d)

            def qkv_bwd_plain():
                return fa.hp_bwd_reference(qkv.view(b, s, 3 * h * d), do_s,
                                           h, scale).view(qkv.shape)

            timed = {
                "fused_fwd": (lambda: fa.fused_fwd(q, k, v, scale),
                              lambda: fa.fused_fwd_reference(q, k, v, scale),
                              lambda: sdpa_ms(q, k, v)),
                "fused_bwd": (lambda: fa.fused_bwd(q, k, v, do, scale),
                              lambda: fa.fused_bwd_reference(q, k, v, do,
                                                             scale),
                              lambda: sdpa_ms(q, k, v, do)),
                "qkv_fwd": (lambda: fa.qkv_fwd(qkv, scale=scale),
                            qkv_fwd_plain, lambda: sdpa_ms(qv, kv, vv)),
                "qkv_bwd": (lambda: fa.qkv_bwd(qkv, do_s, scale=scale),
                            qkv_bwd_plain,
                            lambda: sdpa_ms(qv, kv, vv, dov))}
            # forward: q, k, v read, o written; q·kᵀ and p·v. Backward:
            # q, k, v, dO read, dq, dk, dv written; q·kᵀ, dO·vᵀ, pᵀ·dO,
            # ds·k, dsᵀ·q
            sq, n = b * h * s * s * d, b * s * h * d
            for name, (kernel, plain, library) in timed.items():
                row[f"{name}_ms"] = cuda_ms(kernel)
                row[f"{name}_plain_ms"] = cuda_ms(plain)
                row[f"{name}_library_ms"] = library()
                bwd = name.endswith("bwd")
                row[f"{name}_bound_ms"], row[f"{name}_bound_by"] = bound(
                    (10 if bwd else 4) * sq, 2 * (7 if bwd else 4) * n)
        results[shape] = row
        log(f"[fused kernel] B={b} S={s} H={h} D={d}: "
            + " ".join(f"{k}={v!r}" for k, v in row.items()))
    o_err, g_err, g_ref = held("qkv views", FUSED_VIEW_SHAPE, view_run)
    worst["fused_fwd"] = max(worst["fused_fwd"], o_err)
    worst["fused_bwd"] = max(worst["fused_bwd"], g_err)
    log(f"[fused kernel] multi_head_attention on the (B, H, S, D) views of "
        f"a {FUSED_VIEW_SHAPE} (B, S, H, D) qkv buffer: o_max_abs_err="
        f"{o_err!r} grads_max_abs_err={g_err!r} grads_max_abs={g_ref!r}")

    wide_fused(counts, fa, dev)
    # past the kernels' S (as JAX routes it): the shape rule sends both
    # entry points to reference_attention, no kernel
    for b, s, h, d in REFERENCE_FUSED_SHAPES:
        counts(reset=True)
        q, k, v = (leaf((b, h, s, d), 6950 + i) for i in range(3))
        route = fa.fused_kernel_route(q, k, v)
        o = multi_head_attention(q, k, v, use_pallas=True)
        o.backward(torch.ones_like(o))
        qkv = leaf((b, s, 3, h, d), 6953)
        route_qkv = fa.fused_kernel_route(*heads5(qkv))
        o2 = fa.fused_attention_qkv(qkv)
        o2.backward(torch.ones_like(o2))
        torch.cuda.synchronize()
        ref_launches = counts()
        tag = f"(B, S, H, D) = {(b, s, h, d)}"
        check(route == route_qkv == "reference",
              f"{tag}: routes {route}, {route_qkv} (want reference)")
        check(not any(ref_launches.values()),
              f"{tag} launched {ref_launches} (want none)")
        o_r = fa.fused_fwd_reference(q.detach(), k.detach(), v.detach(),
                                     d ** -0.5)
        o2_r = fa.fused_fwd_reference(*heads5(qkv.detach()), d ** -0.5)
        err = max((o.float() - o_r.float()).abs().max().item(),
                  (o2.view(b, s, h, d).transpose(1, 2).float()
                   - o2_r.float()).abs().max().item())
        check(err <= O_ATOL and torch.isfinite(q.grad.float()).all().item()
              and torch.isfinite(qkv.grad.float()).all().item(),
              f"{tag}: o max abs err {err} > {O_ATOL} or grads not finite")
        log(f"[fused kernel] {tag}: route {route!r} (reference_attention), "
            f"no launch ({ref_launches}); o max abs err vs "
            f"fused_fwd_reference {err!r}")
    return launches, results, worst


def wide_fused(counts, fa, dev) -> None:
    """Both entry points at WIDE_FUSED_SHAPES in bf16, fp16 and fp32: the
    route says what `wide_route` says (the wide tensor-core tiles up to
    256 in bf16 and fp16, else the CUDA cores), K7 and K8 (or K11 and K12)
    launch once each,
    and o and the gradients hold against the plain versions relative to
    their largest |value| (WIDE_REL); K7 and K8 timed beside their plain
    versions at the first shape."""
    import torch

    def heads5(qkv):
        return qkv.permute(2, 0, 3, 1, 4).unbind(0)

    for dt_name in ("bfloat16", "float16", "float32"):
        dt = getattr(torch, dt_name)
        for shape in WIDE_FUSED_SHAPES:
            b, s, h, d = shape
            seed = 6960 + s + d
            x = [seeded_bf16((b, h, s, d), seed + i, dev, dt)
                 for i in range(3)]
            do = seeded_bf16((b, h, s, d), seed + 3, dev, dt)
            scale = d ** -0.5
            want = (fa.fused_fwd_reference(*x, scale),
                    *fa.fused_bwd_reference(*x, do, scale))
            tag = f"{dt_name} (B, S, H, D) = {shape}"
            route = wide_route(dt_name, d)
            check(fa.fused_kernel_route(*x) == route
                  and fa.bwd_kernel_route(*x, do) == route,
                  f"{tag}: routes {fa.fused_kernel_route(*x)}, "
                  f"{fa.bwd_kernel_route(*x, do)} (want {route})")
            errs = {}
            for entry, pair in (("fused_attention", ("FUSED_FWD_LAUNCHES",
                                                     "FUSED_BWD_LAUNCHES")),
                                ("fused_attention_qkv",
                                 ("QKV_FWD_LAUNCHES", "QKV_BWD_LAUNCHES"))):
                counts(reset=True)
                if entry == "fused_attention":
                    leaves = [t.clone().requires_grad_() for t in x]
                    o = fa.fused_attention(*leaves)
                    o.backward(do)
                    got = (o, *(t.grad for t in leaves))
                else:
                    qkv = torch.stack([t.transpose(1, 2) for t in x],
                                      dim=2).requires_grad_()
                    o = fa.fused_attention_qkv(qkv)
                    o.backward(do.transpose(1, 2).reshape(b, s, h * d))
                    got = (o.view(b, s, h, d).transpose(1, 2),
                           *heads5(qkv.grad))
                torch.cuda.synchronize()
                n = counts()
                check(n == {c: int(c in pair) for c in n},
                      f"{tag} {entry} launched {n} (want one each of {pair})")
                err = []
                for g, w in zip(got, want):
                    e = (g.float() - w.float()).abs().max().item()
                    lim = WIDE_REL[dt_name] * w.float().abs().max().item()
                    check(g.dtype == dt and e <= lim, f"{tag} {entry}: "
                          f"{g.dtype}, max abs err {e} > {lim}")
                    err.append(e)
                errs[entry] = err
            row = {"o_and_grads_max_abs_err": errs,
                   "max_abs": [w.float().abs().max().item() for w in want]}
            if shape == WIDE_FUSED_SHAPES[0]:
                row["fused_fwd_ms"] = cuda_ms(lambda: fa.fused_fwd(*x))
                row["fused_fwd_plain_ms"] = cuda_ms(
                    lambda: fa.fused_fwd_reference(*x, scale))
                row["fused_bwd_ms"] = cuda_ms(lambda: fa.fused_bwd(*x, do))
                row["fused_bwd_plain_ms"] = cuda_ms(
                    lambda: fa.fused_bwd_reference(*x, do, scale))
            log(f"[fused kernel] wide head {tag}: route {route!r} "
                + " ".join(f"{k}={v!r}" for k, v in row.items()))
            del x, do, want, got, o


def state_flags(out, *extra):
    """The recipe's flags for phase 24's runs into `out`."""
    return RECIPE_FLAGS + [
        "--epochs", str(STATE_EPOCHS),
        "--limit_steps_per_epoch", str(STATE_STEPS),
        "--limit_eval_batches", str(STATE_EVALS),
        "--output_dir", out, *extra]


class Preempted(Exception):
    """Raised where phase 24 stops a run, as a preemption would."""


def preempted_main(trainer, cfg, at_epoch: int) -> None:
    """main(cfg) stopped when `at_epoch` starts, after the checkpoint of
    the epoch before it."""
    run_epoch = trainer.train_one_epoch

    def stop(ctx, epoch, *args):
        if epoch == at_epoch:
            raise Preempted(epoch)
        return run_epoch(ctx, epoch, *args)

    trainer.train_one_epoch = stop
    try:
        trainer.main(cfg)
    except Preempted:
        pass
    else:
        check(False, f"the run was not stopped at epoch {at_epoch}")
    finally:
        trainer.train_one_epoch = run_epoch


def state_diff(a, b) -> dict:
    """Largest |a - b| of two saved train states, by group (params, EMA,
    mu, nu); the host step and count must be equal."""
    import torch

    check(a["step"] == b["step"]
          and a["opt_state"]["count"] == b["opt_state"]["count"],
          f"step/count {a['step']}, {a['opt_state']['count']} vs "
          f"{b['step']}, {b['opt_state']['count']}")
    groups = {"params": (a["params"], b["params"]),
              "ema": (a["ema_params"], b["ema_params"]),
              "mu": (a["opt_state"]["mu"], b["opt_state"]["mu"]),
              "nu": (a["opt_state"]["nu"], b["opt_state"]["nu"])}
    out = {}
    for g, (x, y) in groups.items():
        check(set(x) == set(y), f"{g}: names differ")
        out[g] = max((x[k].float() - y[k].float()).abs().max().item()
                     for k in x)
    return out


def trace_kernels(path) -> dict:
    """{kernel name: launches} of a Chrome trace that torch.profiler wrote
    (events of category 'kernel')."""
    import collections

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return dict(collections.Counter(
        e["name"] for e in events if e.get("cat") == "kernel"))


def sinks_ab(trainer, cfg_off, cfg_on, dev) -> dict:
    """The recipe step's median CUDA-event time inside train_one_epoch
    with the sinks off (cfg_off) and on (cfg_on: --output_dir,
    TensorBoard, and the watchdog main() starts), in turns off, on, off,
    on; one fixed host batch feeds every step of both."""
    import itertools

    import torch

    from vision_transformers_torch_xla_tpu_torch.obs.watchdog import (
        StepWatchdog,
    )

    ctxs = {"off": trainer.setup(cfg_off), "on": trainer.setup(cfg_on)}
    ctxs["on"].watchdog = StepWatchdog(timeout_s=900.0).start()
    live = sorted(ctxs["on"].loggers)
    batch = next(iter(ctxs["off"].train_ds))
    times = {"off": [], "on": []}
    try:
        for turn in ("off", "on", "off", "on"):
            ctx = ctxs[turn]
            ctx.train_ds = itertools.repeat(batch)
            events, step = [], ctx.train_step

            def timed(*a, _step=step, **kw):
                out = _step(*a, **kw)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
                return out

            ctx.train_step = timed
            trainer.train_one_epoch(ctx, 0,
                                    STATE_AB_WARMUP + STATE_AB_STEPS + 1)
            ctx.train_step = step
            torch.cuda.synchronize()
            times[turn] += [events[i].elapsed_time(events[i + 1])
                            for i in range(STATE_AB_WARMUP,
                                           len(events) - 1)]
    finally:
        ctxs["on"].watchdog.stop()
    return {"sinks_live": live,
            "off_ms": statistics.median(times["off"]),
            "on_ms": statistics.median(times["on"]),
            "off_spread_ms": (min(times["off"]), max(times["off"])),
            "on_spread_ms": (min(times["on"]), max(times["on"]))}


def phase_state(counts, dev, ckpt_path, phase9_step):
    """Phase 24 (module docstring)."""
    import gc
    import shutil
    import tempfile

    import numpy as np
    import torch

    from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
    from vision_transformers_torch_xla_tpu_torch.launch.serve import (
        InferenceEngine,
        serve,
    )
    from vision_transformers_torch_xla_tpu_torch.models import create_model

    t_phase = time.perf_counter()
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke_state_",
                            dir=os.path.join(REPO, "build"))
    whole, cont = os.path.join(root, "whole"), os.path.join(root, "cont")

    def newest(out):
        return CheckpointManager(os.path.join(out, "checkpoints")
                                 ).restore_raw()

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    per_step = dict(ATTN_FWD_LAUNCHES=12 * (STATE_STEPS + STATE_EVALS),
                    ATTN_BWD_LAUNCHES=12 * STATE_STEPS)
    try:
        # resume: uninterrupted, against stopped at epoch 1 and run again
        counts(reset=True)
        whole_stats = trainer.main(config_from_args(state_flags(whole)))
        n = counts()
        check(n == only(**{k: v * STATE_EPOCHS for k, v in per_step.items()}),
              f"the uninterrupted run launched {n}")
        preempted_main(trainer, config_from_args(state_flags(cont)), 1)
        check(CheckpointManager(os.path.join(cont, "checkpoints")
                                ).all_epochs() == [0],
              "the stopped run did not leave epoch 0 alone")
        counts(reset=True)
        cont_stats = trainer.main(config_from_args(state_flags(cont)))
        resumed = counts()
        check(resumed == only(**per_step),
              f"the resumed epoch launched {resumed} (want K1 "
              f"{per_step['ATTN_FWD_LAUNCHES']}, K2 "
              f"{per_step['ATTN_BWD_LAUNCHES']}: 12 a step, as phase 9)")
        check(cont_stats["epoch"] == STATE_EPOCHS - 1,
              f"the resumed run ended at epoch {cont_stats['epoch']}")
        diff = state_diff(newest(whole), newest(cont))
        log(f"[state] resumed vs uninterrupted, largest |difference| by "
            f"group: {diff!r}; train_loss {cont_stats['train_loss']!r} vs "
            f"{whole_stats['train_loss']!r}")
        if any(diff.values()):
            # not bitwise: the witness is the uninterrupted run done twice
            again = os.path.join(root, "again")
            trainer.main(config_from_args(state_flags(again)))
            witness = state_diff(newest(whole), newest(again))
            shutil.rmtree(again)
            log(f"[state] witness (the uninterrupted run twice): "
                f"{witness!r}; limit {STATE_WITNESS_FACTOR} x witness")
            for g, d in diff.items():
                check(d <= STATE_WITNESS_FACTOR * witness[g],
                      f"{g}: resumed differs by {d}, the witness by "
                      f"{witness[g]}")
        else:
            log("[state] the resumed run equals the uninterrupted one "
                "bitwise (params, EMA, mu, nu, step, count)")
        free()

        # --eval from --resume gives the trained state's top-1
        ev = trainer.main(config_from_args(state_flags(
            "", "--eval", "true", "--resume",
            os.path.join(cont, "checkpoints"))))
        log(f"[state] --eval --resume: {ev!r}; the run's last eval "
            f"acc1 {cont_stats['acc1']!r} loss {cont_stats['loss']!r}")
        check(ev["acc1"] == cont_stats["acc1"],
              f"--eval from the checkpoint: top-1 {ev['acc1']} != "
              f"{cont_stats['acc1']}")
        check(abs(ev["loss"] - cont_stats["loss"]) <=
              1e-4 * abs(cont_stats["loss"]),
              f"--eval from the checkpoint: loss {ev['loss']} != "
              f"{cont_stats['loss']}")

        # KD: the teacher (plain attention, as JAX builds it) launches none
        counts(reset=True)
        kd = trainer.main(config_from_args(RECIPE_FLAGS + [
            "--limit_steps_per_epoch", str(STATE_KD_STEPS),
            "--disable_eval", "true", "--kd", "true",
            "--teacher_model", "my_vit_b", "--teacher_path", ckpt_path]))
        n = counts()
        check(n == only(ATTN_FWD_LAUNCHES=12 * STATE_KD_STEPS,
                        ATTN_BWD_LAUNCHES=12 * STATE_KD_STEPS),
              f"{STATE_KD_STEPS} KD steps launched {n} (want the student's "
              f"12 a step)")
        check(np.isfinite(kd["train_loss"]), f"KD loss {kd['train_loss']}")
        log(f"[state] KD, teacher my_vit_b from {ckpt_path}: {kd!r}, "
            f"launches {n}")
        free()

        # serving from the checkpoints directory, EMA weights
        cfg = config_from_args(state_flags(cont))
        model_kw = dict(num_classes=cfg.nb_classes, img_size=cfg.input_size,
                        global_pool=cfg.global_pool, act_layer=cfg.act_layer)
        counts(reset=True)
        engine = InferenceEngine(cfg.model, os.path.join(cont, "checkpoints"),
                                 image_size=cfg.input_size,
                                 num_classes=cfg.nb_classes, use_ema=True,
                                 device=dev.type, global_pool=cfg.global_pool,
                                 act_layer=cfg.act_layer)
        with open(os.path.join(REPO, "tests", "data", "serve_0.jpg"),
                  "rb") as f:
            jpeg = f.read()
        server = serve(engine, port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/predict",
                data=jpeg, method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                topk = json.loads(r.read())["topk"]
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        check(not any(counts().values()),
              f"the server launched {counts()}")
        ema = newest(cont)["ema_params"]
        model = create_model(cfg.model, device=dev, **model_kw)
        model.load_state_dict(ema, strict=True)
        with torch.inference_mode():
            probs = torch.softmax(model.eval()(torch.from_numpy(
                engine._decode(jpeg)[None]).to(dev)), -1)[0].cpu().numpy()
        want = np.argsort(probs)[::-1][:5].tolist()
        log(f"[state] served from the checkpoints dir (EMA): {topk!r}; "
            f"in-process EMA forward top-5 {want!r}")
        check([c for c, _ in topk] == want,
              f"served {topk}, the restored EMA's top-5 {want}")
        del engine, model
        free()

        # one save and one restore of the recipe state, timed
        ctx = trainer.setup(config_from_args(state_flags("")))
        timing = CheckpointManager(os.path.join(root, "timing"))
        save_s, restore_s = [], []
        for epoch in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timing.save(epoch, ctx.state, metadata={"epoch": epoch})
            save_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            timing.restore(ctx.state, epoch)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
        size = os.path.getsize(os.path.join(root, "timing", "1", "state.pt"))
        n_values = sum(t.numel() for g in ("params", "ema_params")
                       for t in getattr(ctx.state, g).values()) + sum(
            t.numel() for g in ("mu", "nu")
            for t in ctx.state.opt_state[g].values())
        log(f"[state] my_vit_b b{TRAIN_BATCH} recipe state ({n_values} fp32 "
            f"values: params, mu, nu, EMA) on {nvidia_smi()}: save "
            f"{save_s!r} s, restore {restore_s!r} s (the file just written, "
            f"likely from the page cache), {size} bytes on disk")
        shutil.rmtree(os.path.join(root, "timing"))
        del ctx
        free()

        # the sinks' A/B in this process
        obs = os.path.join(root, "obs")
        ab = sinks_ab(trainer, config_from_args(state_flags("")),
                      config_from_args(state_flags(
                          obs, "--enable_tensorboard", "true",
                          "--log_dir", os.path.join(obs, "tb"))), dev)
        log(f"[state] recipe step in train_one_epoch on {nvidia_smi()}, "
            f"{STATE_AB_STEPS} steps a turn after {STATE_AB_WARMUP}, turns "
            f"off, on, off, on: sinks off median {ab['off_ms']!r} ms "
            f"(range {ab['off_spread_ms']!r}), on ({ab['sinks_live']} + "
            f"watchdog) median {ab['on_ms']!r} ms (range "
            f"{ab['on_spread_ms']!r}); phase 9's step {phase9_step!r}")
        free()

        # rotation, the loggers and the profiler: the CLI in its own process
        tb = os.path.join(whole, "tb")
        cmd = [sys.executable, "-m", f"{PKG}.launch.main", *state_flags(
            whole, "--epochs", str(STATE_EPOCHS + 1), "--save_ckpt_num", "2",
            "--enable_tensorboard", "true", "--log_dir", tb,
            "--profile_steps", "2")]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                             timeout=STATE_TIMEOUT_S,
                             env={**os.environ, "PYTHONPATH": REPO})
        cli_s = time.perf_counter() - t0
        log(f"[state] CLI run (epoch {STATE_EPOCHS}, auto-resumed) in "
            f"{cli_s:.1f} s, rc {run.returncode}; its last lines:\n"
            + "\n".join(run.stdout.strip().splitlines()[-4:]))
        check(run.returncode == 0,
              f"the CLI run failed: {run.stderr[-3000:]}")
        kept = CheckpointManager(os.path.join(whole, "checkpoints")
                                 ).all_epochs()
        check(kept == [1, 2], f"--save_ckpt_num 2 over 3 epochs left {kept}")
        lines = [json.loads(l) for l in open(os.path.join(whole, "log.txt"))]
        check([r["epoch"] for r in lines] == [0, 1, 2],
              f"log.txt epochs {[r['epoch'] for r in lines]}")
        events = [n for n in os.listdir(tb)
                  if n.startswith("events.out.tfevents")]
        traces = [os.path.join(tb, "profile", n)
                  for n in os.listdir(os.path.join(tb, "profile"))]
        check(len(traces) == 1, f"profile traces {traces}")
        kernels = trace_kernels(traces[0])
        # csrc/'s kernels sit in a top-level anonymous namespace, PyTorch's
        # in at::native's; per step of the 2-step window, name up to '<'
        ours = {k.split("::", 1)[1].split("<")[0]: v / 2
                for k, v in kernels.items()
                if k.startswith("void (anonymous namespace)::")}
        log(f"[state] TensorBoard event files {events}; profile trace "
            f"{os.path.getsize(traces[0])} bytes, {sum(kernels.values()) / 2} "
            f"kernel launches a step ({len(kernels)} kernels); csrc/'s "
            f"kernels a step: {ours!r}")
        check(events, f"no TensorBoard event file under {tb}")
        check(any("attn_fwd_tc_kernel" in k for k in kernels)
              and any("attn_bwd_tc" in k for k in kernels),
              f"the trace names no K1 and K2 kernel: {sorted(kernels)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    took = time.perf_counter() - t_phase
    log(f"[state] phase 24 took {took:.1f} s")
    return {"resumed_launches": resumed, "diff": diff, "ab": ab,
            "save_s": save_s, "restore_s": restore_s, "bytes": size,
            "phase_s": took}


class record_dtypes:
    """Records the dtype of the qkv buffer each call of K1's and K2's
    wrappers receives (ops/flash_attention.py's module functions, which
    qkv_proj_attention calls by name)."""

    def __init__(self, fa):
        self.fa, self.seen = fa, {"attn_fwd": set(), "attn_bwd": set()}

    def __enter__(self):
        self.saved = {n: getattr(self.fa, n) for n in self.seen}
        for name, fn in self.saved.items():
            def wrapped(qkv, *args, _fn=fn, _name=name, **kw):
                self.seen[_name].add(str(qkv.dtype))
                return _fn(qkv, *args, **kw)
            setattr(self.fa, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.fa, name, fn)


def phase_bf16_pure(counts, fa, dev, bf16_step):
    """Phase 25: main() on my_vit_b with the recipe's flags and --precision
    bf16_pure for TRAIN_STEPS steps and EVAL_BATCHES eval batches, then the
    timed step, beside phase 9's (bf16) step time and peak memory."""
    import torch

    state = {}

    def inspect(ctx):
        state["params"] = {str(p.dtype) for p in ctx.state.params.values()}
        state["ema"] = {str(p.dtype) for p in ctx.state.ema_params.values()}
        state["moments"] = {str(t.dtype) for k in ("mu", "nu")
                            for t in ctx.state.opt_state[k].values()}

    with record_dtypes(fa) as seen:
        launches, step = phase_train(counts, dev, BF16_PURE_FLAGS,
                                     TRAIN_BATCH, fixed_batch=False,
                                     tag="train bf16_pure", inspect=inspect)
    log(f"[train bf16_pure] params {state['params']}, EMA {state['ema']}, "
        f"AdamW moments {state['moments']}; K1/K2 saw {seen.seen}")
    check(state["params"] == state["ema"] == {str(torch.bfloat16)},
          f"bf16_pure: params {state['params']}, EMA {state['ema']}")
    check(seen.seen == {"attn_fwd": {str(torch.bfloat16)},
                        "attn_bwd": {str(torch.bfloat16)}},
          f"bf16_pure: K1/K2 instantiations {seen.seen}")
    log(f"[train bf16_pure] my_vit_b b{TRAIN_BATCH} recipe step on "
        f"{nvidia_smi()}: --precision bf16_pure {step['step_ms']!r} ms, "
        f"peak memory {step['peak_mem_gib']!r} GiB; --precision bf16 (phase "
        f"9) {bf16_step['step_ms']!r} ms, {bf16_step['peak_mem_gib']!r} GiB")
    return launches, step


def aug_batch(seed: int, dev):
    """AUG_BATCH seeded 224-px images of 8-bit pixels over 255 (as decoded
    JPEGs are), NHWC fp32 on `dev`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 256, (AUG_BATCH, 224, 224, 3), dtype=np.uint8)
    return torch.from_numpy(pixels).to(dev).float() / 255.0


def phase_aug(dev):
    """Phase 26 (module docstring). Returns the times."""
    import dataclasses

    import numpy as np
    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.data import device_aug as da
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    cpu = torch.device("cpu")
    n = AUG_CPU_IMAGES
    cfg = trainer.device_aug_config(config_from_args(AUG_FLAGS))
    log(f"[aug] {' '.join(AUG_FLAGS)}: {cfg}")
    x = aug_batch(7, dev)
    x_cpu = x[:n].cpu()

    def first(draw):
        """The draw of the first n images."""
        return dataclasses.replace(draw, **{
            f: getattr(draw, f)[:n] for f in ("crop", "flip", "jitter",
                                              "erase_gate", "erase")},
            noise=None if draw.noise is None else draw.noise[:n].cpu())

    # each RandAugment op, forced through the draw, alone
    only_ra = dataclasses.replace(cfg, use_rrc=False, use_flip=False,
                                  reprob=0.0, randaug_layers=1)
    base = da.sample_augment(np.random.default_rng(8), AUG_BATCH, only_ra)
    worst, times = {}, {}
    for i, name in enumerate(da.RA_OP_NAMES):
        mag = AUG_MAG if i % 2 == 0 else -AUG_MAG
        draw = dataclasses.replace(base, ra=((i, mag),))
        got = da.apply_augment(x, draw, only_ra)
        want = da.apply_augment(x_cpu, first(draw), only_ra)
        err = (got[:n].cpu() - want).abs().max().item()
        worst[name] = err
        limit = 0.0 if name in AUG_QUANTIZING else AUG_ATOL
        check(err <= limit, f"aug {name}: card vs CPU {err} > {limit}")
        times[name] = cuda_ms(lambda: da.apply_augment(x, draw, only_ra))
    log(f"[aug] each RandAugment op (magnitude +-{AUG_MAG}) on the card "
        f"against the CPU, worst |error| {worst!r}")
    log(f"[aug] each op's apply_augment at b{AUG_BATCH} 224 px (the op and "
        f"the normalization), median CUDA-event ms on {nvidia_smi()}: "
        f"{times!r}")

    # the whole pipeline with the recipe's flags, the same draws and noise
    draw = da.sample_augment(np.random.default_rng(9), AUG_BATCH, cfg)
    noise = torch.randn((AUG_BATCH, cfg.out_size, cfg.out_size, 3),
                        generator=torch.Generator().manual_seed(10))
    draw = dataclasses.replace(draw, noise=noise.to(dev))
    got = da.apply_augment(x, draw, cfg)
    want = da.apply_augment(x_cpu, first(draw), cfg)
    diff = (got[:n].cpu() - want).abs()
    far = (diff > AUG_CHAIN_ATOL).float().mean().item()
    step = (1.0 + 1e-5) / min(cfg.std)
    log(f"[aug] augment_batch on the card against the CPU (layers "
        f"{draw.ra}, {int(draw.flip.sum())} flips, "
        f"{int(draw.erase_gate.sum())} erased): worst |error| "
        f"{diff.max().item()!r}, share over {AUG_CHAIN_ATOL}: {far!r}")
    check(diff.max().item() <= step and far <= AUG_CHAIN_SHARE,
          f"augment_batch: card vs CPU worst {diff.max().item()}, share "
          f"{far}")
    check(got.shape == (AUG_BATCH, 224, 224, 3)
          and bool(torch.isfinite(got).all()), "augment_batch output")

    # no hidden device-to-host read: the draws go up, nothing comes back
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        da.apply_augment(x, dataclasses.replace(draw, noise=None), cfg,
                         torch.Generator(device=dev).manual_seed(11))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("[aug] apply_augment ran under torch.cuda.set_sync_debug_mode"
        "('error'): no synchronizing call")

    rng, gen = np.random.default_rng(12), torch.Generator(device=dev)
    out = {"augment_batch_ms": cuda_ms(
               lambda: da.augment_batch(rng, x, cfg, gen)),
           "apply_augment_ms": cuda_ms(
               lambda: da.apply_augment(x, draw, cfg)),
           "worst_op_err": worst, "chain_err": diff.max().item()}
    log(f"[aug] b{AUG_BATCH} 224 px with {' '.join(AUG_FLAGS)} on "
        f"{nvidia_smi()}: augment_batch (host draws + device work) "
        f"{out['augment_batch_ms']!r} ms, apply_augment alone "
        f"{out['apply_augment_ms']!r} ms (median CUDA-event time)")
    return out


def smooth_jpeg(rng) -> bytes:
    """One seeded JPEG of 256-320 px: a smooth colour field (an 8-bit grid
    upsampled) with a little noise."""
    import io

    import numpy as np
    from PIL import Image

    h, w = (int(v) for v in rng.integers(256, 321, 2))
    grid = rng.integers(0, 256, (h // 32 + 1, w // 32 + 1, 3),
                        dtype=np.uint8)
    img = np.asarray(Image.fromarray(grid).resize(
        (w, h), Image.Resampling.BILINEAR), np.int16)
    img += rng.integers(-8, 9, img.shape, dtype=np.int16)
    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
        buf, format="JPEG", quality=90)
    return buf.getvalue()


def write_folder(root: str, seed: int = 0) -> str:
    """FOLDER_CLASSES x FOLDER_PER_CLASS seeded JPEGs (smooth_jpeg)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for c in range(FOLDER_CLASSES):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(FOLDER_PER_CLASS):
            with open(os.path.join(d, f"{i:03d}.jpg"), "wb") as f:
                f.write(smooth_jpeg(rng))
    return root


def write_wds(root: str, seed: int = 0) -> str:
    """WDS_SHARDS tar shards of WDS_PER_SHARD seeded JPEGs (smooth_jpeg)
    and their .cls files, labels 0-999; returns their brace range."""
    import io
    import tarfile

    import numpy as np

    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for s in range(WDS_SHARDS):
        with tarfile.open(os.path.join(root, f"train-{s:04d}.tar"),
                          "w") as tar:
            for i in range(WDS_PER_SHARD):
                key = f"{s:04d}{i:05d}"
                for ext, data in (
                        ("jpg", smooth_jpeg(rng)),
                        ("cls", str(int(rng.integers(0, 1000))).encode())):
                    info = tarfile.TarInfo(f"{key}.{ext}")
                    info.size = len(data)
                    tar.addfile(info, io.BytesIO(data))
    return os.path.join(root, f"train-{{0000..{WDS_SHARDS - 1:04d}}}.tar")


def phase_folder_aug(counts, dev):
    """Phase 27: main() on my_vit_b with the recipe's flags, --data_set
    folder on a tree the phase writes, and --device_augment (AUG_FLAGS);
    then the recipe step on the folder's first batch with and without
    --device_augment, in turns. Returns main()'s launches and the times."""
    import gc
    import math
    import shutil

    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.data.loader import to_device
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    root = os.path.join(REPO, "build", "smoke", "folder")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    write_folder(root)
    log(f"[folder aug] wrote {FOLDER_CLASSES} x {FOLDER_PER_CLASS} JPEGs "
        f"under {root} in {time.perf_counter() - t0:.1f} s")
    folder = ["--data_set", "folder", "--data_path", root,
              "--eval_data_path", root]
    flags = RECIPE_FLAGS + folder + AUG_FLAGS
    cfg = config_from_args(flags)
    counts(reset=True)
    t0 = time.perf_counter()
    stats = trainer.main(cfg)
    torch.cuda.synchronize()
    launches = counts()
    log(f"[folder aug] main() {' '.join(folder + AUG_FLAGS)}: "
        f"{time.perf_counter() - t0:.3f} s, stats {stats}, launches "
        f"{launches}")
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for v in stats.values()), f"stats not finite: {stats}")
    check(stats["count"] == EVAL_BATCHES * cfg.eval_batch_size(),
          f"evaluated {stats['count']} images")

    # the recipe step on the folder's first batch: raw pixels augmented in
    # the step, against the normalized batch without it; in turns
    ctxs, batches = {}, {}
    for aug in (False, True):
        c = config_from_args(RECIPE_FLAGS + folder
                             + (AUG_FLAGS if aug else []))
        ctxs[aug] = trainer.setup(c)
        batches[aug] = to_device(next(iter(ctxs[aug].train_ds)), dev)
    x_raw = batches[True][0]
    check(float(x_raw.min()) >= 0.0 and float(x_raw.max()) <= 1.0,
          "--device_augment: the folder batch is not raw [0, 1] pixels")
    runs = {False: [], True: []}
    for _ in range(FOLDER_AB_ROUNDS):
        for aug in (False, True):
            runs[aug].append(time_steps(ctxs[aug], *batches[aug],
                                        WARMUP_STEPS, TIMED_STEPS))
    out = {}
    for aug, rows in runs.items():
        key = "with_aug" if aug else "without_aug"
        out[key] = {"step_ms": [r[0] for r in rows],
                    "host_step_ms": [r[1] for r in rows],
                    "peak_mem_gib": max(r[2] for r in rows) / 2**30}
    log(f"[folder aug] my_vit_b b{TRAIN_BATCH} recipe step on the folder's "
        f"first batch on {nvidia_smi()}, in turns (without, with) x "
        f"{FOLDER_AB_ROUNDS}, median CUDA-event ms of {TIMED_STEPS} steps: "
        f"without --device_augment {out['without_aug']!r}; with "
        f"{out['with_aug']!r}")
    del ctxs, batches
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(root, ignore_errors=True)
    return launches, out


def phase_reg4(counts, fb, dev, ckpt_dir):
    """Phase 28: the reg4 DINOv2 at 518 px. The bf16 forward against its
    fp32 golden; one train-mode forward + backward against the train
    golden without and with remat, each call of K4-K6 in the remat run held
    against its plain version on the model's data, and the largest
    difference of the two gradients; then main() at b32 without and with
    --grad_checkpointing, each with its timed step and peak memory.
    Returns the two main() runs' launches by remat."""
    import torch

    depth, t0 = M2_GOLDEN_DEPTH, time.perf_counter()
    ckpt = os.path.join(ckpt_dir, f"{REG4_MODEL}_d{depth}_seed0.pth")
    n = phase_model(counts, dev, ckpt, REG4_MODEL, LONG_GAMMA,
                    tag="reg4 model")
    check(n == only(FLASH_FWD_LAUNCHES=depth),
          f"one reg4 forward launched {n} (want K4 {depth})")
    grads = {}
    for remat in (False, True):
        with swap_blocked(fb, plain=False) as checked:
            n = phase_grad(counts, dev, ckpt, REG4_MODEL,
                           tag=f"reg4 grad remat={remat}",
                           limits=LONG_GRAD_LIMITS,
                           keep=grads.setdefault(remat, {}), remat=remat)
        check(n == only(FLASH_FWD_LAUNCHES=depth * (1 + remat),
                        FLASH_BWD_DKDV_LAUNCHES=depth,
                        FLASH_BWD_DQ_LAUNCHES=depth),
              f"one reg4 forward + backward, remat={remat}, launched {n}")
        log(f"[reg4 grad remat={remat}] K4-K6 vs plain at each call on the "
            f"model's data (S 1374), worst error (over max |plain| but "
            f"lse): {checked.worst!r}")
        for name, err in checked.worst.items():
            limit = {"o": O_REL_ATOL, "lse": LSE_ATOL}.get(name,
                                                           DQKV_REL_ATOL)
            check(err <= limit, f"reg4 data, {name}: error {err} > {limit}")
    diff = {k: (grads[True][k].float() - grads[False][k].float()).abs()
            .max().item() for k in grads[False]}
    worst = max(diff, key=diff.get)
    log(f"[reg4 grad] remat against no remat: largest gradient difference "
        f"{diff[worst]!r} ({worst}), {sum(v == 0 for v in diff.values())} of "
        f"{len(diff)} parameters bitwise equal")
    del grads
    runs, steps = {}, {}
    for remat in (False, True):
        flags = REG4_FLAGS + (["--grad_checkpointing", "true"] if remat
                              else [])
        runs[remat], steps[remat] = phase_train(
            counts, dev, flags, LONG_BATCH, 518, 14, fixed_batch=False,
            warmup=M2_WARMUP_STEPS, timed=M2_TIMED_STEPS,
            tag=f"reg4 train remat={remat}")
        per = 2 if remat else 1
        check(runs[remat] == only(
            FLASH_FWD_LAUNCHES=12 * (per * TRAIN_STEPS + EVAL_BATCHES),
            FLASH_BWD_DKDV_LAUNCHES=12 * TRAIN_STEPS,
            FLASH_BWD_DQ_LAUNCHES=12 * TRAIN_STEPS),
              f"reg4 main() remat={remat}: {runs[remat]} for {TRAIN_STEPS} "
              f"steps, {EVAL_BATCHES} evals")
        log(f"[reg4 train remat={remat}] a train step launches K4 "
            f"{12 * per}, K5 12, K6 12 (an eval batch K4 12)")
    log(f"[reg4 train] {REG4_MODEL} b{LONG_BATCH} step on {nvidia_smi()}: "
        f"without remat {steps[False]['step_ms']!r} ms, peak "
        f"{steps[False]['peak_mem_gib']!r} GiB; with --grad_checkpointing "
        f"{steps[True]['step_ms']!r} ms, peak {steps[True]['peak_mem_gib']!r}"
        f" GiB")
    check(steps[True]["peak_mem_gib"] < steps[False]["peak_mem_gib"],
          "remat did not lower the peak memory")
    torch.cuda.empty_cache()
    log(f"[time] phase 28 took {time.perf_counter() - t0:.1f} s")
    return runs


def phase_siglip(counts, dev, ckpt_dir):
    """Phase 29: SigLIP. The bf16 forward on the kernel route against its
    fp32 golden (K1 a block, the MAP head plain), the server's requests
    (no kernel), main() at b128 with --pallas_attn auto and its timed
    step. Returns main()'s launches."""
    depth, t0 = M2_GOLDEN_DEPTH, time.perf_counter()
    ckpt = os.path.join(ckpt_dir, f"{SIGLIP_MODEL}_d{depth}_seed0.pth")
    n = phase_model(counts, dev, ckpt, SIGLIP_MODEL, tag="siglip model")
    check(n == only(ATTN_FWD_LAUNCHES=depth),
          f"one SigLIP forward launched {n} (want K1 {depth})")
    # the server builds the full model and seeds it itself (no checkpoint)
    served, median_ms = phase_serve(counts, "", SIGLIP_MODEL,
                                    tag="siglip serve", global_pool="map")
    check(served == 0, f"the SigLIP server launched {served}")
    log(f"[siglip serve] median request latency {median_ms!r} ms on "
        f"{nvidia_smi()}")
    launches, step = phase_train(counts, dev, SIGLIP_FLAGS, TRAIN_BATCH,
                                 fixed_batch=False, warmup=M2_WARMUP_STEPS,
                                 timed=M2_TIMED_STEPS, tag="siglip train")
    check(launches == only(
        ATTN_FWD_LAUNCHES=12 * (TRAIN_STEPS + EVAL_BATCHES),
        ATTN_BWD_LAUNCHES=12 * TRAIN_STEPS),
          f"SigLIP main(): {launches} for {TRAIN_STEPS} steps, "
          f"{EVAL_BATCHES} evals")
    log(f"[time] phase 29 took {time.perf_counter() - t0:.1f} s")
    return launches


def phase_block_types(counts, dev):
    """Phase 30: main() on each model of BLOCK_TYPE_RUNS for TRAIN_STEPS
    steps and EVAL_BATCHES eval batches; finite stats, and K1 and K2 as
    the JAX route gives them. Returns the launches by model."""
    t0, out = time.perf_counter(), {}
    for name, per in BLOCK_TYPE_RUNS.items():
        flags = ["--model", name, "--batch_size", str(BLOCK_TYPE_BATCH),
                 "--data_set", "synthetic", "--epochs", "1",
                 "--limit_steps_per_epoch", str(TRAIN_STEPS),
                 "--limit_eval_batches", str(EVAL_BATCHES),
                 "--warmup_epochs", "0", "--drop_path", "0.1"]
        out[name], stats = phase_train(counts, dev, flags, BLOCK_TYPE_BATCH,
                                       fixed_batch=False, timed=None,
                                       tag=f"block types {name}")
        check(out[name] == only(
            ATTN_FWD_LAUNCHES=per * (TRAIN_STEPS + EVAL_BATCHES),
            ATTN_BWD_LAUNCHES=per * TRAIN_STEPS),
              f"{name} main(): {out[name]} (want K1 {per} a forward, K2 "
              f"{per} a step)")
    log(f"[time] phase 30 took {time.perf_counter() - t0:.1f} s")
    return out


def phase_scan(counts, dev):
    """Phase 31: --scan_blocks on the recipe's fixed batch (mixup off,
    lr 1e-4): SCAN_STEPS losses bitwise equal to loop mode's, K1 and K2
    12 a step in both."""
    import gc

    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.data.loader import to_device
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    t0, losses, launches = time.perf_counter(), {}, {}
    fixed = RECIPE_FLAGS + ["--mixup", "0", "--cutmix", "0", "--lr", "1e-4",
                            "--min_lr", "1e-4", "--warmup_epochs", "0"]
    for scan in (False, True):
        cfg = config_from_args(fixed + (["--scan_blocks", "true"] if scan
                                        else []))
        ctx = trainer.setup(cfg)
        check(ctx.model.scan_blocks == scan, "scan_blocks did not reach "
              "the model")
        images, labels = to_device(next(iter(ctx.train_ds)), dev)
        counts(reset=True)
        out = []
        for _ in range(SCAN_STEPS):
            ctx.state, m = ctx.train_step(ctx.state, images, labels,
                                          cfg.seed)
            out.append(m["loss"])
        losses[scan] = torch.stack(out).tolist()
        launches[scan] = counts()
        del ctx, m
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[scan] my_vit_b fixed batch, {SCAN_STEPS} steps: loop losses "
        f"{losses[False]!r}, --scan_blocks losses {losses[True]!r}; "
        f"launches {launches}")
    check(losses[True] == losses[False], "scan and loop losses differ")
    for scan in (False, True):
        check(launches[scan] == only(ATTN_FWD_LAUNCHES=12 * SCAN_STEPS,
                                     ATTN_BWD_LAUNCHES=12 * SCAN_STEPS),
              f"scan={scan}: {launches[scan]}")
    log(f"[time] phase 31 took {time.perf_counter() - t0:.1f} s")


WORLD1_STEPS = 3
WORLD1_LOSS_RTOL = 1e-6
GLOO_BATCH = 64          # per rank; the one-process step takes 2 x GLOO_BATCH
GLOO_STEPS = 2
GLOO_TIMEOUT_S = 300
GLOO_PARAM_ATOL = 1e-4
# bf16 compute: the ranks' GEMMs are half as tall as the one-process
# step's, so cuBLAS may sum in another order and round activations and
# gradients to bf16 elsewhere
GLOO_GRAD_REL_L2 = 2e-2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class record_draws:
    """Within the block, the model's input of every train forward and
    every keep mask it draws (models/layers.py::_keep_mask) are kept."""

    def __init__(self, model):
        from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
            unwrap,
        )

        self.model = unwrap(model)
        self.inputs, self.masks = [], []

    def __enter__(self):
        from vision_transformers_torch_xla_tpu_torch.models import layers

        self.layers, self.draw = layers, layers._keep_mask

        def keep_mask(*args):
            mask = self.draw(*args)
            self.masks.append(mask.clone())
            return mask

        def pre_hook(module, args, kwargs):
            if not (args[1] if len(args) > 1 else
                    kwargs.get("deterministic", True)):
                self.inputs.append(args[0].detach().clone())

        layers._keep_mask = keep_mask
        self.handle = self.model.register_forward_pre_hook(pre_hook,
                                                           with_kwargs=True)
        return self

    def __exit__(self, *exc):
        self.layers._keep_mask = self.draw
        self.handle.remove()


def fixed_global_batch(cfg, dev):
    """The first batch of 2 x GLOO_BATCH of cfg's synthetic stream
    (process 0), on `dev`."""
    from vision_transformers_torch_xla_tpu_torch.data.loader import (
        SyntheticDataset,
        to_device,
    )

    ds = SyntheticDataset(2 * GLOO_BATCH, cfg.input_size, cfg.nb_classes,
                          seed=cfg.seed)
    return to_device(next(iter(ds)), dev)


def phase_world1(counts, dev, plain_launches):
    """Phase 32: the recipe's trainer over a world-1 NCCL group. Returns
    the DDP and FSDP2 main() runs' launches and each trainer's timed
    step."""
    import gc
    import shutil

    import torch
    import torch.distributed as dist

    from vision_transformers_torch_xla_tpu_torch.ckpt.checkpoint import (
        CheckpointManager,
    )
    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.data.loader import to_device
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
    from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
        is_fsdp,
        unwrap,
    )

    t0 = time.perf_counter()
    runs = {"plain": [], "ddp": ["--mesh_shape", "data"],
            "fsdp": ["--param_sharding", "fsdp"]}
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    launches, losses, steps = {}, {}, {}
    try:
        for name, extra in runs.items():
            cfg = config_from_args(RECIPE_FLAGS + extra)
            if name != "plain":
                # the group comes up in the first wrapped setup, from env;
                # FSDP2's main() also saves its (gathered) checkpoint
                os.environ.update(env)
                out = os.path.join(REPO, "build", "smoke", "world1_fsdp")
                shutil.rmtree(out, ignore_errors=True)
                counts(reset=True)
                stats = trainer.main(config_from_args(
                    RECIPE_FLAGS + extra + (["--output_dir", out]
                                            if name == "fsdp" else [])))
                torch.cuda.synchronize()
                launches[name] = counts()
                log(f"[world1 {name}] main(): stats {stats}, launches "
                    f"{launches[name]}")
                check(launches[name] == plain_launches,
                      f"{name} main() launched {launches[name]}, the plain "
                      f"main() {plain_launches}")
                check(dist.get_backend() == "nccl"
                      and dist.get_world_size() == 1,
                      f"group: {dist.get_backend()} x "
                      f"{dist.get_world_size()}")
            ctx = trainer.setup(cfg)
            if name == "fsdp":
                saved = CheckpointManager(os.path.join(
                    out, "checkpoints")).restore_raw()["params"]
                check({k: t.shape for k, t in saved.items()}
                      == {k: p.shape for k, p in ctx.state.params.items()}
                      and all(torch.isfinite(t).all()
                              for t in saved.values()),
                      "FSDP2's checkpoint does not hold the whole params")
                log(f"[world1 fsdp] main()'s checkpoint holds the "
                    f"{len(saved)} whole params")
                del saved
                shutil.rmtree(out)
            wrapper = "fsdp" if is_fsdp(ctx.model) else (
                "ddp" if unwrap(ctx.model) is not ctx.model else "plain")
            check(wrapper == name, f"{name}: the trainer built {wrapper}")
            images, labels = to_device(next(iter(ctx.train_ds)), dev)
            counts(reset=True)
            fixed = []
            for _ in range(WORLD1_STEPS):
                ctx.state, m = ctx.train_step(ctx.state, images, labels,
                                              cfg.seed)
                fixed.append(m["loss"])
            losses[name] = torch.stack(fixed).tolist()
            n = counts()
            check(n == only(ATTN_FWD_LAUNCHES=12 * WORLD1_STEPS,
                            ATTN_BWD_LAUNCHES=12 * WORLD1_STEPS),
                  f"{name}: {WORLD1_STEPS} fixed steps launched {n}")
            step_ms, host_ms, peak = time_steps(ctx, images, labels,
                                                WARMUP_STEPS, TIMED_STEPS)
            steps[name] = {"step_ms": step_ms, "host_step_ms": host_ms,
                           "peak_mem_gib": peak / 2**30}
            log(f"[world1 {name}] my_vit_b b{TRAIN_BATCH} recipe step on "
                f"{nvidia_smi()}: median {step_ms!r} ms over {TIMED_STEPS} "
                f"steps (host clock {host_ms!r} ms/step), peak memory "
                f"{peak / 2**30!r} GiB; fixed-batch losses {losses[name]!r}")
            del ctx, m
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    for name in ("ddp", "fsdp"):
        same = losses[name] == losses["plain"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses[name],
                                                      losses["plain"]))
        log(f"[world1 {name}] losses against the plain step's: "
            f"{'bitwise equal' if same else f'max relative {rel!r}'}")
        check(rel <= WORLD1_LOSS_RTOL, f"{name}: losses {losses[name]} vs "
              f"the plain step's {losses['plain']}")
    log(f"[time] phase 32 took {time.perf_counter() - t0:.1f} s")
    return launches, steps


def gloo_flags():
    return RECIPE_FLAGS + ["--batch_size", str(GLOO_BATCH)]


GLOO_WRAPPERS = {"ddp": "replicated", "fsdp": "fsdp"}


def gloo_rank(rank: int, port: int, out: str) -> None:
    """Phase 33's rank: DDP, then FSDP2, over gloo on cuda:0, GLOO_STEPS
    steps each on its rows of the fixed global batch; saves what it saw
    to out/rank<r>.pt."""
    import datetime
    import faulthandler
    import gc

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    sys.path.insert(0, REPO)
    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
    from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
        is_fsdp,
        unwrap,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    saved = {}
    for name, sharding in GLOO_WRAPPERS.items():
        cfg = config_from_args(gloo_flags() + [
            "--device", "cuda:0", "--param_sharding", sharding])
        ctx = trainer.setup(cfg)
        check(is_fsdp(ctx.model) if name == "fsdp" else
              unwrap(ctx.model) is not ctx.model,
              f"rank {rank}: the model is not under {name}")
        got = gloo_steps(ctx, cfg, slice(rank * GLOO_BATCH,
                                         (rank + 1) * GLOO_BATCH))
        if rank and name == "ddp":  # rank 0 holds the same whole tensors
            got = {k: got[k] for k in ("inputs", "masks", "losses")}
        saved[name] = got
        del ctx
        gc.collect()
        torch.cuda.empty_cache()
    torch.save(saved, os.path.join(out, f"rank{rank}.pt"))
    dist.destroy_process_group()


def gloo_steps(ctx, cfg, rows) -> dict:
    """GLOO_STEPS steps of ctx on `rows` of the fixed global batch: the
    inputs and masks seen, the global losses, this rank's part of the
    first step's gradients and of the params after the steps (the whole
    tensors under DDP, the dim-0 shards under FSDP2: DTensor.full_tensor
    of uneven CUDA shards over gloo segfaults in torch 2.11, so the parent
    puts the shards end to end), on the host."""
    from vision_transformers_torch_xla_tpu_torch.launch.main import (
        global_metrics,
    )
    from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
        local,
    )

    images, labels = fixed_global_batch(cfg, ctx.device)
    losses = []
    with record_draws(ctx.model) as seen:
        for s in range(GLOO_STEPS):
            ctx.state, m = ctx.train_step(ctx.state, images[rows],
                                          labels[rows], cfg.seed)
            losses.append(float(global_metrics(ctx, m)["loss"]))
            if s == 0:
                grads = {k: local(p.grad).float().cpu()
                         for k, p in ctx.state.params.items()}
    return {"inputs": [x.cpu() for x in seen.inputs],
            "masks": [x.cpu() for x in seen.masks], "losses": losses,
            "grads": grads, "params": {k: local(p.detach()).float().cpu()
                                       for k, p in ctx.state.params.items()}}


def phase_gloo(counts):
    """Phase 33: two gloo ranks on this card against the one-process step
    on their batches put end to end."""
    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    t0 = time.perf_counter()
    out = os.path.join(REPO, "build", "smoke", "gloo")
    os.makedirs(out, exist_ok=True)
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke; chip_smoke.gloo_rank({r}, {port}, {out!r})"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        # the one-process step on the global batch, while the ranks run
        cfg = config_from_args(gloo_flags() + ["--batch_size",
                                               str(2 * GLOO_BATCH)])
        counts(reset=True)
        ref = gloo_steps(trainer.setup(cfg), cfg, slice(None))
        n = counts()
        check(n == only(ATTN_FWD_LAUNCHES=12 * GLOO_STEPS,
                        ATTN_BWD_LAUNCHES=12 * GLOO_STEPS),
              f"the one-process reference launched {n}")
        errs = []
        for r, p in enumerate(procs):
            out_r, err = p.communicate(timeout=GLOO_TIMEOUT_S)
            errs.append(f"rank {r} exit {p.returncode}: {out_r[-2000:]}"
                        f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(all(p.returncode == 0 for p in procs),
          f"a gloo rank failed: {errs}")
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
             for r in range(2)]
    for name in GLOO_WRAPPERS:
        for r in range(2):
            got, rows = ranks[r][name], slice(r * GLOO_BATCH,
                                              (r + 1) * GLOO_BATCH)
            for kind in ("inputs", "masks"):
                check(len(got[kind]) == len(ref[kind]),
                      f"{name} rank {r}: {len(got[kind])} {kind}, want "
                      f"{len(ref[kind])}")
                for i, (a, b) in enumerate(zip(got[kind], ref[kind])):
                    check(torch.equal(a, b[rows]),
                          f"{name} rank {r}: {kind} {i} differs from the "
                          f"one-process step's rows")
        grads, params = ranks[0][name]["grads"], ranks[0][name]["params"]
        if name == "fsdp":  # FSDP2's dim-0 shards, rank 0's first
            other = ranks[1][name]
            grads = {k: torch.cat([t, other["grads"][k]])
                     for k, t in grads.items()}
            params = {k: torch.cat([t, other["params"][k]])
                      for k, t in params.items()}
        grad_err = {k: float((grads[k] - g).norm()
                             / g.norm().clamp_min(1e-30))
                    for k, g in ref["grads"].items()}
        param_err = {k: float((params[k] - p).abs().max())
                     for k, p in ref["params"].items()}
        worst_g = max(grad_err, key=grad_err.get)
        worst_p = max(param_err, key=param_err.get)
        log(f"[gloo {name}] 2 ranks x b{GLOO_BATCH} over gloo on one card "
            f"against the one-process b{2 * GLOO_BATCH} step: inputs and "
            f"drop-path masks ({len(ref['masks'])} draws a rank) bitwise "
            f"equal; global losses {ranks[0][name]['losses']!r} (rank 1 "
            f"{ranks[1][name]['losses']!r}) against {ref['losses']!r}; "
            f"first-step gradients worst relative L2 {grad_err[worst_g]!r} "
            f"({worst_g}); params after {GLOO_STEPS} steps worst "
            f"{param_err[worst_p]!r} ({worst_p})")
        check(grad_err[worst_g] <= GLOO_GRAD_REL_L2,
              f"{name} gradient {worst_g}: {grad_err[worst_g]}")
        check(param_err[worst_p] <= GLOO_PARAM_ATOL,
              f"{name} param {worst_p}: {param_err[worst_p]}")
    log(f"[time] phase 33 took {time.perf_counter() - t0:.1f} s")


def phase_wds(counts, dev, phase9_step):
    """Phase 34: main() on my_vit_b with the recipe's flags on webdataset
    shards the phase writes; the WdsDataset iterator's host rate beside
    phase 9's step; --data_set tfrecord without TensorFlow. Returns
    main()'s launches."""
    import importlib.util
    import math
    import shutil

    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.data import native
    from vision_transformers_torch_xla_tpu_torch.data.loader import (
        build_dataset,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    t_phase = time.perf_counter()
    root = os.path.join(REPO, "build", "smoke", "wds")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    spec = write_wds(root)
    decoder = "native/libvtx_io.so's pool" if native.available() else "PIL"
    log(f"[wds] wrote {WDS_SHARDS} shards x {WDS_PER_SHARD} JPEGs as {spec} "
        f"in {time.perf_counter() - t0:.1f} s; they decode through "
        f"{decoder}")
    flags = RECIPE_FLAGS + ["--data_set", "wds", "--data_path", spec]
    cfg = config_from_args(flags)
    counts(reset=True)
    t0 = time.perf_counter()
    stats = trainer.main(cfg)
    torch.cuda.synchronize()
    launches = counts()
    log(f"[wds] main() --data_set wds: {time.perf_counter() - t0:.3f} s, "
        f"stats {stats}, launches {launches}")
    check(all(isinstance(v, (int, float)) and math.isfinite(v)
              for v in stats.values()), f"stats not finite: {stats}")
    check(stats["count"] == EVAL_BATCHES * cfg.eval_batch_size(),
          f"evaluated {stats['count']} images")

    # the train set's iterator alone: one epoch of host decode, crop,
    # resize, flip and normalization, no step
    ds, info = build_dataset(cfg, True)
    t0 = time.perf_counter()
    n = sum(len(labels) for _, labels in ds)
    took = time.perf_counter() - t0
    check(n == info.num_examples // cfg.batch_size * cfg.batch_size,
          f"one epoch of the wds train set gave {n} images")
    log(f"[wds] on {nvidia_smi()}: the WdsDataset train iterator ({decoder}, "
        f"{os.cpu_count()} host cores) {n / took!r} images/s ({n} images in "
        f"{took!r} s); phase 9's my_vit_b b{TRAIN_BATCH} recipe step "
        f"{phase9_step['images_per_s']!r} images/s on a fixed device batch")

    # the tf.data sources need TensorFlow, which this machine may lack
    if importlib.util.find_spec("tensorflow") is None:
        tfr = config_from_args(RECIPE_FLAGS + [
            "--data_set", "tfrecord", "--data_path",
            os.path.join(root, "train-*.tfrecord")])
        try:
            build_dataset(tfr, True)
        except ImportError as e:
            check("tensorflow" in str(e), f"--data_set tfrecord: {e}")
            log(f"[wds] no TensorFlow here: --data_set tfrecord raised "
                f"ImportError: {e}")
        else:
            check(False, "--data_set tfrecord built without TensorFlow")
    else:
        log("[wds] TensorFlow is installed here: --data_set tfrecord is not "
            "driven by this smoke")
    shutil.rmtree(root, ignore_errors=True)
    log(f"[time] phase 34 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# Phase 35, the model axis: each run's ranks on cuda:0 over gloo, as
# phase 33's: (base flags, mesh flags, ranks, global batch, checked steps)
TP_RUNS = {
    "tp": (RECIPE_FLAGS, ["--mesh_shape", "data:1,model:2"], 2, 64, 2),
    "tp_mlp": (PALLAS_MLP_FLAGS, ["--mesh_shape", "data:1,model:2"], 2, 64,
               2),
    "tp_fsdp": (RECIPE_FLAGS, ["--mesh_shape", "data:2,model:2",
                               "--param_sharding", "fsdp"], 4, 64, 1),
    "sp": (LONG_TRAIN_FLAGS, ["--mesh_shape", "data:1,model:2",
                              "--param_sharding", "sp"], 2, 8, 1)}
TP_TIMEOUT_S = 600
# bf16 compute: a split layer rounds each rank's partial product to bf16
# before the ranks' fp32 sum, where one GEMM rounds the whole sum once, and
# under sp the gathered sequence's GEMMs are as tall as the one-process
# step's but the per-token ones half as tall: the activations and
# gradients move by a few bf16 ulps. The params move by lr x the
# warm-up's first steps (warmup_lr 1e-6), so GLOO_PARAM_ATOL holds them.
TP_LOSS_RTOL = 5e-3
TP_GRAD_NORM_RTOL = 2e-2
TP_GRAD_REL_L2 = 5e-2
# what each run's kernels see: heads a rank (K1, K2), hidden columns a
# rank (K3), tokens of the gathered sequence (K4-K6)
TP_HEADS, TP_COLUMNS, SP_TOKENS = 6, 1536, 1370
# each run's kernels: their counts, and what their names in a trace hold
_K12 = {"ATTN_FWD_LAUNCHES": "attn_fwd_tc", "ATTN_BWD_LAUNCHES": "attn_bwd_tc"}
TP_KERNELS = {"tp": _K12, "tp_mlp": {**_K12, "FC2_BWD_LAUNCHES": "fc2_bwd"},
              "tp_fsdp": _K12,
              "sp": {"FLASH_FWD_LAUNCHES": "flash_fwd",
                     "FLASH_BWD_DKDV_LAUNCHES": "flash_bwd_dkdv",
                     "FLASH_BWD_DQ_LAUNCHES": "flash_bwd_dq"}}


def tp_flags(name: str, ranks: int) -> list:
    """The run's flags for `ranks` processes: the mesh only for more than
    one, and --batch_size the global batch over them."""
    base, mesh, _, n, _ = TP_RUNS[name]
    return base + (mesh if ranks > 1 else []) + ["--batch_size",
                                                 str(n // ranks)]


def tp_batch(cfg, n: int, dev):
    """The first batch of n of cfg's synthetic stream (process 0), on
    `dev`: the global batch of phase 35's runs."""
    from vision_transformers_torch_xla_tpu_torch.data.loader import (
        SyntheticDataset,
        to_device,
    )

    ds = SyntheticDataset(n, cfg.input_size, cfg.nb_classes, seed=cfg.seed)
    return to_device(next(iter(ds)), dev)


class kernel_shapes:
    """Within the block, what the wrappers of K1, K2, K3 and K4 are called
    on: K1's and K2's head count and qkv width, K3's hidden columns, K4's
    q shape (the wrappers are looked up by name at each call)."""

    def __init__(self, fa, fb, mf):
        self.mods = ((fa, "attn_fwd"), (fa, "attn_bwd"), (mf, "fc2_bwd"),
                     (fb, "flash_fwd"))
        self.seen = {"attn_fwd": set(), "attn_bwd": set(), "fc2_bwd": set(),
                     "flash_fwd": set()}

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.mods]
        for (mod, name), fn in zip(self.mods, self.saved):
            setattr(mod, name, self._spy(name, fn))
        return self

    def _spy(self, name, fn):
        def call(*args, **kwargs):
            if name == "attn_fwd":
                self.seen[name].add((args[1], args[0].shape[-1]))
            elif name == "attn_bwd":
                self.seen[name].add((args[4], args[0].shape[-1]))
            elif name == "fc2_bwd":
                self.seen[name].add(args[2].shape[-1])
            else:
                self.seen[name].add(tuple(args[0].shape))
            return fn(*args, **kwargs)

        return call

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.mods, self.saved):
            setattr(mod, name, fn)


def tp_steps(ctx, cfg, images, labels, steps: int, trace: bool = False):
    """`steps` steps of ctx on (images, labels): the global losses and
    grad norms, this rank's part of the first step's gradients and of the
    params after each step (local: the split part, and under FSDP2 its
    dim-0 shard), on the host; with `trace`, the csrc/ kernels of the first
    step from a torch.profiler session; then one more step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vision_transformers_torch_xla_tpu_torch.launch.main import (
        global_metrics,
    )
    from vision_transformers_torch_xla_tpu_torch.parallel.sharding import (
        local,
    )

    out = {"losses": [], "grad_norms": [], "params": [], "kernels": []}
    for s in range(steps):
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])
              if trace and s == 0 else contextlib.nullcontext()) as prof:
            ctx.state, m = ctx.train_step(ctx.state, images, labels,
                                          cfg.seed)
            m = global_metrics(ctx, m)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
            torch.cuda.synchronize()
        if prof is not None:   # csrc/'s kernels, by name and template
            out["kernels"] = sorted({
                e.key.split("::", 1)[1].split("(")[0]
                for e in prof.key_averages()
                if re.match(CSRC_KERNEL, e.key)})
        if s == 0:
            out["grads"] = {k: local(p.grad).float().cpu()
                            for k, p in ctx.state.params.items()}
        out["params"].append({k: local(p.detach()).float().cpu()
                              for k, p in ctx.state.params.items()})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ctx.state, m = ctx.train_step(ctx.state, images, labels, cfg.seed)
    float(m["loss"])
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def tp_rank(name: str, rank: int, port: int, out: str,
            device: str = "cuda:0") -> None:
    """Phase 35's rank of run `name`: the trainer on the run's mesh over
    gloo, its steps on its data index's rows of the global batch with the
    kernels' shapes and launches kept, saved to out/<name>_rank<r>.pt."""
    import datetime
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    sys.path.insert(0, REPO)
    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
    from vision_transformers_torch_xla_tpu_torch.ops import (
        flash_attention as fa,
        flash_blocked as fb,
        mlp_fused as mf,
    )

    _, _, ranks, n, steps = TP_RUNS[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=ranks,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    cfg = config_from_args(tp_flags(name, ranks) + ["--device", device])
    ctx = trainer.setup(cfg)
    images, labels = tp_batch(cfg, n, ctx.device)
    per = n // ctx.shard.count
    rows = slice(ctx.shard.index * per, (ctx.shard.index + 1) * per)
    counts = counter(*ALL_COUNTS)
    counts(reset=True)
    with kernel_shapes(fa, fb, mf) as shapes:
        got = tp_steps(ctx, cfg, images[rows], labels[rows], steps,
                       trace=device.startswith("cuda"))
        launches = counts()
    got.update(launches=launches, shapes={k: sorted(v) for k, v in
                                          shapes.seen.items()},
               splits={k: (sp.dim, sp.parts)
                       for k, sp in ctx.state.splits.items()},
               data_index=ctx.shard.index, data_size=ctx.shard.count,
               model_size=ctx.mesh.size("model"))
    torch.save(got, os.path.join(out, f"{name}_rank{rank}.pt"))
    dist.destroy_process_group()


def join_ranks(ranks: list, which: str, step=None) -> dict:
    """The whole tensors of `which` ('grads', or 'params' after `step`)
    from every rank's part: the dim-0 shards of the data indices put end
    to end under FSDP2, then the model axis's parts joined as
    parallel/split.py::Split.join joins them."""
    import torch

    first = ranks[0]
    d_n, m_n, fsdp = first["data_size"], first["model_size"], first["fsdp"]

    def part(r):
        t = ranks[r][which]
        return t if step is None else t[step]

    whole = {}
    for k in part(0):
        def model_part(m):
            pieces = [part(d * m_n + m)[k] for d in range(d_n)]
            return torch.cat(pieces) if fsdp else pieces[0]

        if k in first["splits"]:
            dim, parts = first["splits"][k]
            chunks = [model_part(m).chunk(parts, dim) for m in range(m_n)]
            whole[k] = torch.cat([chunks[m][j] for j in range(parts)
                                  for m in range(m_n)], dim)
        else:
            whole[k] = model_part(0)
    return whole


def phase_tp(counts):
    """Phase 35: the model axis on this card. Each run's ranks over gloo
    against the one-process step on their global batch in this process;
    returns each run's launches (rank 0's) and the one-process and split
    steps' wall times."""
    import gc

    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer

    t0 = time.perf_counter()
    out = os.path.join(REPO, "build", "smoke", "tp")
    os.makedirs(out, exist_ok=True)
    launches, times = {}, {}
    ports, started = set(), {}

    def start(name):
        """The run's rank processes, on a port of their own."""
        port = free_port()
        while port in ports:
            port = free_port()
        ports.add(port)
        started[name] = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.tp_rank("
             f"{name!r}, {r}, {port}, {out!r})"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(TP_RUNS[name][2])]

    names = list(TP_RUNS)
    start(names[0])
    try:
        for i, name in enumerate(names):
            n, steps = TP_RUNS[name][3:]
            t_run = time.perf_counter()
            # the next run's ranks start up while this run's step: at
            # most two runs' ranks share the card and the host
            if i + 1 < len(names):
                start(names[i + 1])
            procs = started[name]
            # the one-process step on the global batch, while the ranks run
            cfg = config_from_args(tp_flags(name, 1))
            ctx = trainer.setup(cfg)
            images, labels = tp_batch(cfg, n, ctx.device)
            counts(reset=True)
            ref = tp_steps(ctx, cfg, images, labels, steps)
            ref_launches = counts()
            del ctx
            gc.collect()
            torch.cuda.empty_cache()
            errs = []
            for r, p in enumerate(procs):
                out_r, err = p.communicate(timeout=TP_TIMEOUT_S)
                errs.append(f"rank {r} exit {p.returncode}: {out_r[-2000:]}"
                            f"{err[-3000:]}")
            check(all(p.returncode == 0 for p in procs),
                  f"phase 35 {name}: a rank failed: {errs}")
            check_tp_run(name, ref, ref_launches, out, launches, times,
                         t_run)
    finally:
        for procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    log(f"[time] phase 35 took {time.perf_counter() - t0:.1f} s")
    return launches, times


def check_tp_run(name, ref, ref_launches, out, launches, times, t_run):
    """One phase-35 run's ranks against the one-process step `ref`; adds
    the run's launches (rank 0's) and step times to `launches`, `times`."""
    import gc

    import torch

    _, _, ranks, n, steps = TP_RUNS[name]
    got = [torch.load(os.path.join(out, f"{name}_rank{r}.pt"),
                      weights_only=False) for r in range(ranks)]
    for g in got:
        g["fsdp"] = "fsdp" in TP_RUNS[name][1]
    # every rank's kernels, as many as the one-process step's, on its
    # heads, columns and gathered tokens
    for r, g in enumerate(got):
        check(g["launches"] == ref_launches and all(
            ref_launches[c] > 0 for c in TP_KERNELS[name]),
            f"{name} rank {r}: launches {g['launches']}, the "
            f"one-process step's {ref_launches}")
        for kernel in TP_KERNELS[name].values():
            check(any(kernel in k for k in g["kernels"]),
                  f"{name} rank {r}: the trace of its first step names "
                  f"{g['kernels']}, no {kernel}")
        if name == "sp":
            check(g["shapes"]["flash_fwd"] and all(
                SP_TOKENS in shape for shape in g["shapes"]["flash_fwd"]),
                  f"sp rank {r}: K4 on {g['shapes']['flash_fwd']}")
        else:
            check(g["shapes"]["attn_fwd"] == [(TP_HEADS, 3 * 64 *
                                               TP_HEADS)]
                  and g["shapes"]["attn_bwd"] == [(TP_HEADS, 3 * 64 *
                                                   TP_HEADS)],
                  f"{name} rank {r}: K1/K2 on {g['shapes']}")
        if name == "tp_mlp":
            check(g["shapes"]["fc2_bwd"] == [TP_COLUMNS],
                  f"tp_mlp rank {r}: K3 on {g['shapes']['fc2_bwd']}")
    # against the one-process step
    loss_err = max(abs(a - b) / abs(b) for g in got
                   for a, b in zip(g["losses"], ref["losses"]))
    norm_err = max(abs(a - b) / abs(b) for g in got
                   for a, b in zip(g["grad_norms"], ref["grad_norms"]))
    grads = join_ranks(got, "grads")
    grad_err = {k: float((grads[k] - w).norm()
                         / w.norm().clamp_min(1e-30))
                for k, w in ref["grads"].items()}
    params = join_ranks(got, "params", steps - 1)
    param_err = {k: float((params[k] - w).abs().max())
                 for k, w in ref["params"][-1].items()}
    worst_g = max(grad_err, key=grad_err.get)
    worst_p = max(param_err, key=param_err.get)
    launches[name] = got[0]["launches"]
    times[name] = {"one_process_step_ms": ref["step_ms"],
                   "split_step_ms": [g["step_ms"] for g in got]}
    log(f"[tp {name}] {ranks} ranks over gloo on one card "
        f"({' '.join(TP_RUNS[name][1])}), global b{n}, {steps} step(s), "
        f"against the one-process step: losses {got[0]['losses']!r} vs "
        f"{ref['losses']!r}, worst relative {loss_err!r} (limit "
        f"{TP_LOSS_RTOL}); grad norms {got[0]['grad_norms']!r} vs "
        f"{ref['grad_norms']!r}, worst relative {norm_err!r} (limit "
        f"{TP_GRAD_NORM_RTOL}); first-step gradients worst relative L2 "
        f"{grad_err[worst_g]!r} ({worst_g}; limit {TP_GRAD_REL_L2}); "
        f"params after {steps} step(s) worst {param_err[worst_p]!r} "
        f"({worst_p}; limit {GLOO_PARAM_ATOL}); rank 0 launched "
        f"{launches[name]} on {got[0]['shapes']}, traced "
        f"{got[0]['kernels']}; split parameters {len(got[0]['splits'])}")
    log(f"[tp {name}] one step on {nvidia_smi()}: one process "
        f"{ref['step_ms']!r} ms, each rank of the split run "
        f"{times[name]['split_step_ms']!r} ms (gloo over host memory on "
        f"one card: the wrapper's correctness, not tensor parallelism's "
        f"speed); run took {time.perf_counter() - t_run:.1f} s")
    check(loss_err <= TP_LOSS_RTOL, f"{name}: losses {loss_err}")
    check(norm_err <= TP_GRAD_NORM_RTOL, f"{name}: grad norms {norm_err}")
    check(grad_err[worst_g] <= TP_GRAD_REL_L2,
          f"{name} gradient {worst_g}: {grad_err[worst_g]}")
    check(param_err[worst_p] <= GLOO_PARAM_ATOL,
          f"{name} param {worst_p}: {param_err[worst_p]}")
    del got, grads, params, ref
    gc.collect()


def phase_convnext(counts, dev, ckpt_dir):
    """ConvNeXt through the port's entry points (phase 36): main() on
    convnext_tiny with the ConvNeXt recipe, 2 updates of 4 micro-steps,
    no kernel launched; the micro-step timed; the bf16 forward against the
    JAX fp32 golden; CONVNEXT_REQUESTS requests to a convnext_tiny
    server; one step each of lamb and adahessian on convnext_atto."""
    import gc
    import math

    import numpy as np
    import torch

    from vision_transformers_torch_xla_tpu_torch.core.config import (
        config_from_args,
    )
    from vision_transformers_torch_xla_tpu_torch.core.seeded import (
        seeded_images,
    )
    from vision_transformers_torch_xla_tpu_torch.data.loader import to_device
    from vision_transformers_torch_xla_tpu_torch.launch import main as trainer
    from vision_transformers_torch_xla_tpu_torch.models import create_model

    t0 = time.perf_counter()
    cfg = config_from_args(CONVNEXT_FLAGS)
    made = []
    setup = trainer.setup

    def keep_setup(c):
        made.append(setup(c))
        return made[-1]

    counts(reset=True)
    trainer.setup = keep_setup
    try:
        stats = trainer.main(cfg)
    finally:
        trainer.setup = setup
    torch.cuda.synchronize()
    launches = counts()
    state = made[0].state
    opt = state.opt_state
    updates = opt["gradient_step"]
    log(f"[convnext] main() {CONVNEXT_MODEL} b{TRAIN_BATCH} update_freq "
        f"{CONVNEXT_UPDATE_FREQ}: {state.step} micro-steps, {updates} "
        f"updates (inner count {opt['inner']['count']}), stats {stats}, "
        f"launches {launches}")
    check(math.isfinite(stats["train_loss"]), f"loss {stats['train_loss']}")
    check(state.step == CONVNEXT_MICRO_STEPS and updates == 2
          and opt["inner"]["count"] == 2 and opt["mini_step"] == 0,
          f"{state.step} micro-steps, optimizer count {updates}")
    check(not any(launches.values()),
          f"the ConvNeXt path launched a kernel: {launches}")
    check(all(math.isfinite(v) for v in stats.values()),
          f"stats not finite: {stats}")
    del made[:], state, opt
    gc.collect()
    torch.cuda.empty_cache()

    # the micro-step (mixup, forward, backward, accumulation, every 4th
    # the update; the EMA each) on one device batch
    ctx = trainer.setup(cfg)
    images, labels = to_device(next(iter(ctx.train_ds)), dev)
    step_ms, host_ms, peak = time_steps(ctx, images, labels,
                                        CONVNEXT_UPDATE_FREQ,
                                        2 * CONVNEXT_UPDATE_FREQ)
    ips = TRAIN_BATCH / (step_ms / 1e3)
    log(f"[convnext] {CONVNEXT_MODEL} b{TRAIN_BATCH} 224 px bf16 micro-step "
        f"on {nvidia_smi()}: median {step_ms!r} ms over "
        f"{2 * CONVNEXT_UPDATE_FREQ} micro-steps (2 updates) after "
        f"{CONVNEXT_UPDATE_FREQ} warm-up (host clock {host_ms!r} ms), "
        f"{ips!r} images/s, peak memory {peak / 2**30!r} GiB")
    del ctx
    gc.collect()
    torch.cuda.empty_cache()

    # the bf16 forward against the JAX fp32 golden, on the seeded weights
    # (gammas 1) through a .pth, as phase 4 holds my_vit_b
    with open(os.path.join(REPO, "tests", "data",
                           f"torch_port_golden_{CONVNEXT_MODEL}.json")) as f:
        golden = json.load(f)
    check("gamma=1.0" in golden["weights"], f"golden {golden['weights']}")
    ckpt_path = os.path.join(ckpt_dir, f"{CONVNEXT_MODEL}.pth")
    model = create_model(CONVNEXT_MODEL, device=dev)
    load_seeded(model, ckpt_path, gamma=1.0)
    counts(reset=True)
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(
            seeded_images(2, golden["img_size"], seed=0)).to(dev))
    got = got.float().cpu().numpy()
    want = np.asarray(golden["logits"], np.float32)
    max_abs = float(np.abs(got - want).max())
    rel_l2 = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log(f"[convnext] {CONVNEXT_MODEL} bf16 vs JAX fp32 golden: "
        f"max_abs_err={max_abs!r} rel_l2={rel_l2!r} top1 "
        f"port={got.argmax(1).tolist()} golden={want.argmax(1).tolist()} "
        f"kernel launches={counts()}")
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"logits {got.shape}")
    check(max_abs <= LOGIT_ATOL, f"logits max abs err {max_abs} > "
          f"{LOGIT_ATOL}")
    check(rel_l2 <= LOGIT_REL_L2, f"logits rel L2 {rel_l2} > {LOGIT_REL_L2}")
    del model
    serve_launches, _ = phase_serve(counts, ckpt_path, CONVNEXT_MODEL,
                                    tag="convnext serve",
                                    requests=CONVNEXT_REQUESTS)
    check(serve_launches == 0, f"the server launched {serve_launches}")

    # one step of the whole-tensor and the second-order optimizers
    for name in CONVNEXT_OPTS:
        ocfg = config_from_args(CONVNEXT_FLAGS + [
            "--model", CONVNEXT_OPT_MODEL, "--opt", name, "--update_freq",
            "1"])
        ctx = trainer.setup(ocfg)
        before = {k: p.detach().clone() for k, p in ctx.state.params.items()}
        images, labels = to_device(next(iter(ctx.train_ds)), dev)
        counts(reset=True)
        t1 = time.perf_counter()
        ctx.state, m = ctx.train_step(ctx.state, images, labels, ocfg.seed)
        loss = m["loss"].item()
        ms = (time.perf_counter() - t1) * 1e3
        moved = sum(int((p != before[k]).any())
                    for k, p in ctx.state.params.items())
        finite = all(bool(torch.isfinite(p).all())
                     for p in ctx.state.params.values())
        log(f"[convnext] {name} on {CONVNEXT_OPT_MODEL} b{TRAIN_BATCH}: "
            f"loss {loss!r}, grad norm {m['grad_norm'].item()!r}, "
            f"{moved}/{len(before)} params moved, optimizer count "
            f"{ctx.state.opt_state['count']}, first step {ms:.1f} ms (host "
            f"clock, with its warm-up), launches {counts()}")
        # a tensor whose every update is under half an ulp of its entries
        # (adahessian's lr x g / |D| at the warm-up lr) may stay put
        check(math.isfinite(loss) and finite and 2 * moved >= len(before)
              and ctx.state.opt_state["count"] == 1
              and not any(counts().values()),
              f"{name}: loss {loss}, {moved} params moved, finite {finite}")
        del ctx, before
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[time] phase 36 took {time.perf_counter() - t0:.1f} s")


def counter(*names):
    """counts(reset=False) -> {COUNT: launches} of the counts named
    'module.COUNT' (modules of ops/); reset sets them to 0 first."""
    import importlib

    mods = [(importlib.import_module(f"{PKG}.ops.{m}"), c)
            for m, c in (n.split(".") for n in names)]

    def counts(reset: bool = False):
        if reset:
            for m, c in mods:
                setattr(m, c, 0)
        return {c: getattr(m, c) for m, c in mods}

    return counts


def only(**nonzero):
    """Every launch count 0 but those named."""
    names = [c.split(".")[1] for c in ALL_COUNTS]
    check(set(nonzero) <= set(names), f"unknown counts {sorted(nonzero)}")
    return {n: nonzero.get(n, 0) for n in names}


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script; run it from "
              f"a checkout of the repository", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vision_transformers_torch_xla_tpu_torch.ops import (
        cuda_build,
        flash_attention as fa,
        flash_blocked as fb,
        mlp_fused as mf,
    )

    t_start = time.perf_counter()
    # the plain versions' fp32 matmuls run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    def lap(what):
        # where the run's time goes, toward its 1200 s limit
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    build_s = build_all(fa, fb, mf)
    lap("the builds")
    for name in ("attn_fwd_tc", "attn_bwd_tc", "hp_bwd_tc", "attn_fwd"):
        log(f"[build] {name} built/loaded in {build_s[name]:.3f} s")
        # attn_fwd_simt_kernel, on float alone, names no element type
        log_ptxas(cuda_build, name, "build",
                  untyped="fp32" if name == "attn_fwd" else "bf16")
    # the tensor-core kernels' dynamic shared memory (ptxas reports only
    # the static part)
    fwd_lib, bwd_lib = fa.build_tc_kernels(), fa.build_tc_bwd_kernels()
    hp_lib = fa.build_hp_bwd_tc_kernels()
    for d in (64, 128):
        log(f"[build] dynamic shared memory at D <= {d}: attn_fwd_tc_kernel "
            f"(K1 and K9, and in K7's order K7 and K11) "
            f"{fwd_lib.vtx_attn_fwd_tc_smem(d)} B, attn_bwd_tc_dkdv_kernel "
            f"{bwd_lib.vtx_attn_bwd_tc_smem(d, 0)} B, attn_bwd_tc_dq_kernel "
            f"{bwd_lib.vtx_attn_bwd_tc_smem(d, 1)} B, hp_bwd_tc_dkdv_kernel "
            f"(K8, K10, K12) {hp_lib.vtx_hp_bwd_tc_smem(d, 0)} B, "
            f"hp_bwd_tc_dq_kernel {hp_lib.vtx_hp_bwd_tc_smem(d, 1)} B")
    for d in (192, 256):
        log(f"[build] dynamic shared memory of the wide tiles at D <= {d}: "
            f"attn_fwd_tc_kernel {fwd_lib.vtx_attn_fwd_tc_smem(d)} B, "
            f"attn_bwd_tc_dkdv_wide_kernel "
            f"{bwd_lib.vtx_attn_bwd_tc_smem(d, 0)} B, "
            f"attn_bwd_tc_dq_wide_kernel {bwd_lib.vtx_attn_bwd_tc_smem(d, 1)}"
            f" B, hp_bwd_tc_dkdv_kernel {hp_lib.vtx_hp_bwd_tc_smem(d, 0)} B, "
            f"hp_bwd_tc_dq_kernel {hp_lib.vtx_hp_bwd_tc_smem(d, 1)} B")

    every = counter(*ALL_COUNTS)
    kernel, worst = phase_kernel(fa, dev)
    ckpt_dir = os.path.join(REPO, "build", "smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    ckpt_path = os.path.join(ckpt_dir, "my_vit_b_seed0.pth")
    n = phase_model(every, dev, ckpt_path)
    check(n == only(ATTN_FWD_LAUNCHES=12),
          f"one forward launched {n} (want K1 12)")
    serve_launches, _ = phase_serve(every, ckpt_path, act_layer="gelu_tanh")

    log(f"[build bwd] attn_bwd_tc built/loaded in "
        f"{build_s['attn_bwd_tc']:.3f} s (registers in phase 2)")
    log(f"[build bwd] attn_bwd built/loaded in {build_s['attn_bwd']:.3f} s "
        f"(in parallel with the others)")
    log_ptxas(cuda_build, "attn_bwd", "build bwd", untyped="fp32")
    bwd32 = fa.build_bwd_kernels()
    log(f"[build bwd] dynamic shared memory of attn_bwd_kernel (fp32 K2) "
        f"at D <= 32, 64, 128: "
        f"{[bwd32.vtx_attn_bwd_smem(d) for d in (32, 64, 128)]} B; of "
        f"attn_bwd_wide_kernel (K2 past D 256 in every dtype) "
        f"{bwd32.vtx_attn_bwd_smem(512)} B; the fp32 K2's scratch at "
        f"(B, S, H, D) = {WIDE_TIMED} on csrc/attn_bwd_simt.cu "
        f"{4 * bwd32.vtx_attn_bwd_scratch(32, 197, 12, 256, 2)} B")
    bwd, bwd_worst = phase_bwd_kernel(fa, dev)
    n = phase_grad(every, dev, ckpt_path)
    check(n == only(ATTN_FWD_LAUNCHES=12, ATTN_BWD_LAUNCHES=12),
          f"one forward + backward launched {n} (want K1 12, K2 12)")
    train_launches, default_step = phase_train(every, dev, RECIPE_FLAGS,
                                               TRAIN_BATCH)
    check(train_launches == only(
        ATTN_FWD_LAUNCHES=12 * (TRAIN_STEPS + EVAL_BATCHES),
        ATTN_BWD_LAUNCHES=12 * TRAIN_STEPS),
          f"{train_launches} for {TRAIN_STEPS} steps, {EVAL_BATCHES} evals")
    lap("phases 1-9")

    # ---- the long-sequence slice: vit_base_patch14_dinov2 at 518 px
    for name in ("flash_fwd", "flash_bwd", "flash_blocked"):
        log(f"[build long] {name} built/loaded in {build_s[name]:.3f} s (in "
            f"parallel with the others)")
        # flash_blocked's untyped kernels are csrc/flash_bwd_simt.cu's fp32
        # K5 and K6
        log_ptxas(cuda_build, name, "build long",
                  untyped="fp32" if name == "flash_blocked" else "bf16")
    long_k, long_worst = phase_long_kernel(fb, dev)
    long_ckpt = os.path.join(ckpt_dir, f"{LONG_MODEL}_seed0.pth")
    n = phase_model(every, dev, long_ckpt, LONG_MODEL, LONG_GAMMA,
                    tag="long model")
    check(n == only(FLASH_FWD_LAUNCHES=12),
          f"one 518-px forward launched {n} (want K4 12, K1 0)")
    long_serve, _ = phase_serve(every, long_ckpt, LONG_MODEL,
                                tag="long serve", image_size=518,
                                global_pool="token")
    # K4-K6 held against their plain versions at every call of the step,
    # on the model's own data
    with swap_blocked(fb, plain=False) as checked:
        n = phase_grad(every, dev, long_ckpt, LONG_MODEL, tag="long grad",
                       limits=LONG_GRAD_LIMITS)
    check(n == only(FLASH_FWD_LAUNCHES=12, FLASH_BWD_DKDV_LAUNCHES=12,
                    FLASH_BWD_DQ_LAUNCHES=12),
          f"one 518-px forward + backward launched {n}")
    log(f"[long grad] kernels vs plain at each call on the model's data, "
        f"worst error (over max |plain| but lse): {checked.worst!r}")
    check(set(checked.worst) == {"o", "lse", "dq", "dk", "dv"},
          f"outputs checked: {sorted(checked.worst)}")
    for name, err in checked.worst.items():
        limit = {"o": O_REL_ATOL, "lse": LSE_ATOL}.get(name, DQKV_REL_ATOL)
        check(err <= limit, f"model data, {name}: error {err} > {limit}")
    # the witness: the same bf16 step with the plain versions of K4-K6
    with swap_blocked(fb, plain=True):
        n = phase_grad(every, dev, long_ckpt, LONG_MODEL,
                       tag="long grad witness, plain K4-K6",
                       limits=LONG_GRAD_LIMITS)
    check(not any(n.values()), f"the plain run launched {n}")
    long_train, _ = phase_train(
        every, dev, LONG_TRAIN_FLAGS, LONG_BATCH, 518, 14,
        fixed_batch=False, warmup=LONG_WARMUP_STEPS, timed=LONG_TIMED_STEPS,
        tag="long train")
    check(long_train == only(
        FLASH_FWD_LAUNCHES=12 * (TRAIN_STEPS + EVAL_BATCHES),
        FLASH_BWD_DKDV_LAUNCHES=12 * TRAIN_STEPS,
        FLASH_BWD_DQ_LAUNCHES=12 * TRAIN_STEPS),
          f"{long_train} for {TRAIN_STEPS} steps, {EVAL_BATCHES} evals")

    lap("phases 10-15")

    # ---- the fused-backward MLP (--pallas_mlp on) on my_vit_b, and the
    # head-pair route of fused_attention_qkv_cols
    for name in ("mlp_fused", "hp_bwd"):
        log(f"[build mlp/hp] {name} built/loaded in {build_s[name]:.3f} s "
            f"(in parallel with the others)")
        log_ptxas(cuda_build, name, "build mlp/hp", untyped="fp32")
    log(f"[build mlp/hp] dynamic shared memory of fc2_bwd_tc_kernel (K3 in "
        f"bf16 and fp16) {mf.build_kernels().vtx_fc2_bwd_smem()} B")
    mlp_k, mlp_worst = phase_mlp_kernel(mf, dev)
    t_red = time.perf_counter()
    in_child("trace_redesigned", "the redesigned kernels' traces")
    log(f"[time] the redesigned kernels' traces took "
        f"{time.perf_counter() - t_red:.1f} s")
    # head dims over 128 on every route (its profiler checks stay ahead of
    # the trainer phases 19-22, after which a session records nothing)
    wide_launches, wide_rows, wide_worst = phase_wide_heads(every, fa, fb, mf,
                                                            dev)
    lap("phases 16-17b")
    # ---- the 518-px trainer in fp32: the fp32 K4, and K5 and K6 on
    # csrc/flash_bwd_simt.cu's register tiles, 12 a step each (its profiler
    # session the process's last, after 17b's)
    t_fp32 = time.perf_counter()
    long32, named = phase_long_fp32(every)
    check(long32 == only(
        FLASH_FWD_LAUNCHES=12 * (LONG_FP32_STEPS + LONG_FP32_EVALS),
        FLASH_BWD_DKDV_LAUNCHES=12 * LONG_FP32_STEPS,
        FLASH_BWD_DQ_LAUNCHES=12 * LONG_FP32_STEPS),
          f"main() fp32 at 518 px launched {long32} for {LONG_FP32_STEPS} "
          f"steps, {LONG_FP32_EVALS} evals")
    for kname, count in LONG_FP32_KERNELS.items():
        seen = sum(n for key, n in named.items() if f"::{kname}(" in key)
        check(seen == long32[count], f"main() fp32 at 518 px: {kname} "
              f"launched {seen} times, the wrapper counted {long32[count]}")
    check(all(any(f"::{kname}(" in key for kname in LONG_FP32_KERNELS)
              for key in named),
          f"main() fp32 at 518 px launched other csrc/ kernels: {named}")
    # its gradient against the JAX fp32 golden, after the witness: the same
    # fp32 step with the plain versions of K4-K6 on the card; then on the
    # kernels, each call held against its plain version on the model's data
    with swap_blocked(fb, plain=True):
        n = phase_grad(every, dev, long_ckpt, LONG_MODEL,
                       tag="long grad fp32 witness, plain K4-K6",
                       limits=LONG_FP32_GRAD_LIMITS, dtype=torch.float32)
    check(not any(n.values()), f"the plain run launched {n}")
    with swap_blocked(fb, plain=False) as checked:
        n = phase_grad(every, dev, long_ckpt, LONG_MODEL,
                       tag="long grad fp32", limits=LONG_FP32_GRAD_LIMITS,
                       dtype=torch.float32)
    check(n == only(FLASH_FWD_LAUNCHES=12, FLASH_BWD_DKDV_LAUNCHES=12,
                    FLASH_BWD_DQ_LAUNCHES=12),
          f"one fp32 518-px forward + backward launched {n}")
    log(f"[long grad fp32] kernels vs plain at each call on the model's "
        f"data, worst error (over max |plain| but lse): {checked.worst!r}")
    check(set(checked.worst) == {"o", "lse", "dq", "dk", "dv"},
          f"outputs checked: {sorted(checked.worst)}")
    for name, err in checked.worst.items():
        limit = LSE_ATOL if name == "lse" else DTYPE_REL["float32"]
        check(err <= limit, f"model data, fp32 {name}: error {err} > {limit}")
    log(f"[long fp32] the fp32 518-px phase took "
        f"{time.perf_counter() - t_fp32:.1f} s")
    # ---- K4 and K5 on the tensor cores in fp16 and at head dims 129-256
    t_tc = time.perf_counter()
    tc_rows, tc_worst = phase_tc_blocked(every, fb, dev)
    log(f"[tc blocked] phase 17d took {time.perf_counter() - t_tc:.1f} s")
    # ---- the fp32 K4, K5 and K6 at head dims 129-256 on the wide register
    # tiles: their times at (32, 1370, 12, 256) join the wide lines' _b32
    # keys, their edges' worst error the lines' max_abs_err
    t_w = time.perf_counter()
    w_rows, w_worst = phase_fp32_wide_blocked(every, fb, dev)
    tc_rows.update(w_rows)
    for name, err in w_worst.items():
        wide_worst[("float32", name)] = max(wide_worst[("float32", name)],
                                            err)
    log(f"[fp32 wide blocked] phase 17e took "
        f"{time.perf_counter() - t_w:.1f} s")
    lap("phases 17c-17e")
    with check_fc2_bwd(mf) as k3:
        n = phase_grad(every, dev, ckpt_path, tag="grad pallas_mlp",
                       use_pallas_mlp=True)
    check(n == only(ATTN_FWD_LAUNCHES=12, ATTN_BWD_LAUNCHES=12,
                    FC2_BWD_LAUNCHES=12),
          f"one --pallas_mlp on forward + backward launched {n} (want K1, "
          f"K2, K3 12 each)")
    log(f"[grad pallas_mlp] K3 vs plain at each call on the model's data, "
        f"worst error over max |plain|: {k3.worst!r}")
    check(set(k3.worst) == {"dh", "a", "db1"},
          f"outputs checked: {sorted(k3.worst)}")
    for name, err in k3.worst.items():
        limit = DB1_REL_ATOL if name == "db1" else DH_REL_ATOL
        check(err <= limit, f"model data, {name}: error {err} > {limit}")
    mlp_train, mlp_step = phase_train(every, dev, PALLAS_MLP_FLAGS,
                                      TRAIN_BATCH, fixed_batch=False,
                                      tag="train pallas_mlp")
    check(mlp_train == only(
        ATTN_FWD_LAUNCHES=12 * (TRAIN_STEPS + EVAL_BATCHES),
        ATTN_BWD_LAUNCHES=12 * TRAIN_STEPS,
        FC2_BWD_LAUNCHES=12 * TRAIN_STEPS),
          f"{mlp_train} for {TRAIN_STEPS} steps, {EVAL_BATCHES} evals")
    log(f"[train pallas_mlp] A/B of the my_vit_b b{TRAIN_BATCH} recipe step "
        f"on {nvidia_smi()}: --pallas_mlp off {default_step!r}; "
        f"--pallas_mlp on {mlp_step!r}")
    hp_launches, hp_k, hp_worst = phase_hp_kernel(every, fa, dev)
    n_hp = len(HP_MAIN_SHAPES + HP_EXTRA_SHAPES)
    check(hp_launches == only(HP_FWD_LAUNCHES=n_hp, HP_BWD_LAUNCHES=n_hp),
          f"fused_attention_qkv_cols at S <= 1024 launched {hp_launches} "
          f"(want K9 and K10 {n_hp} each)")

    lap("phases 18-20")

    # ---- the op-level fused entry points (K7, K8, K11, K12)
    log(f"[build fused] fused_attn_fwd built/loaded in "
        f"{build_s['fused_attn_fwd']:.3f} s (in parallel with the others)")
    log_ptxas(cuda_build, "fused_attn_fwd", "build fused", untyped="fp32")
    fu_launches, fu_k, fu_worst = phase_fused_kernel(every, fa, dev)
    n_fu = len(FUSED_MAIN_SHAPES + FUSED_EXTRA_SHAPES)
    check(fu_launches == only(
        FUSED_FWD_LAUNCHES=n_fu + 1, FUSED_BWD_LAUNCHES=n_fu + 1,
        QKV_FWD_LAUNCHES=n_fu, QKV_BWD_LAUNCHES=n_fu),
          f"the op-level entry points launched {fu_launches} (want K7 and "
          f"K8 {n_fu + 1} each, K11 and K12 {n_fu} each)")

    # ---- compute other than bf16: the trainer's switch is JAX's, so
    # --precision fp32 trains on the kernels' fp32 instantiations
    prec = phase_precision(every)
    steps, evals, depth = PRECISION_STEPS, PRECISION_EVALS, PRECISION_DEPTH
    attn = dict(ATTN_FWD_LAUNCHES=depth * (steps + evals),
                ATTN_BWD_LAUNCHES=depth * steps)
    for run in ("fp32", "fp32_on", "bf16"):
        check(prec[run] == only(**attn),
              f"main() {run} launched {prec[run]} (want K1, K2 in every "
              f"block)")
    check(prec["fp32_mlp"] == only(**attn, FC2_BWD_LAUNCHES=depth * steps),
          f"main() fp32 --pallas_mlp on launched {prec['fp32_mlp']}")
    # the fp32 my_vit_b gradient on the kernel route against the JAX fp32
    # golden, after its witness: the same fp32 step with K1's and K2's
    # plain versions on the card
    with swap_plain_attention(fa):
        n = phase_grad(every, dev, ckpt_path,
                       tag="grad fp32 witness, plain K1-K2",
                       limits=FP32_GRAD_LIMITS, dtype=torch.float32)
    check(not any(n.values()), f"the plain run launched {n}")
    fp32_grad = phase_grad(every, dev, ckpt_path, tag="grad fp32",
                           limits=FP32_GRAD_LIMITS, dtype=torch.float32)
    check(fp32_grad == only(ATTN_FWD_LAUNCHES=12, ATTN_BWD_LAUNCHES=12),
          f"one fp32 forward + backward launched {fp32_grad} (want K1 12, "
          f"K2 12)")

    lap("phases 21-22")

    # ---- every kernel in fp32 and fp16
    dt_launches, dt_rows, dt_worst = phase_dtypes(every, fa, fb, mf, dev)
    for dt_name, n in dt_launches.items():
        check(n == only(**{c.split(".")[1]: 1 for c in ALL_COUNTS}),
              f"{dt_name}: the entry points launched {n} (want each "
              f"kernel once)")

    lap("phase 23")

    # ---- the trainer's state: resume, rotation, logs, profile, KD, serving
    phase_state(every, dev, ckpt_path, default_step)

    lap("phase 24")

    # ---- --precision bf16_pure, the on-device augmentation, and the folder
    # source behind --device_augment
    t_new = time.perf_counter()
    want_train = only(ATTN_FWD_LAUNCHES=12 * (TRAIN_STEPS + EVAL_BATCHES),
                      ATTN_BWD_LAUNCHES=12 * TRAIN_STEPS)
    pure_launches, _ = phase_bf16_pure(every, fa, dev, default_step)
    check(pure_launches == want_train,
          f"bf16_pure: {pure_launches} for {TRAIN_STEPS} steps, "
          f"{EVAL_BATCHES} evals")
    phase_aug(dev)
    folder_launches, _ = phase_folder_aug(every, dev)
    check(folder_launches == want_train,
          f"folder --device_augment: {folder_launches} for {TRAIN_STEPS} "
          f"steps, {EVAL_BATCHES} evals")
    log(f"[time] phases 25-27 took {time.perf_counter() - t_new:.1f} s")

    # ---- the rest of the ViT: register tokens on K4-K6 with and without
    # remat, SigLIP's MAP head, the other block types, --scan_blocks
    t_m2 = time.perf_counter()
    reg4_runs = phase_reg4(every, fb, dev, ckpt_dir)
    siglip_launches = phase_siglip(every, dev, ckpt_dir)
    block_launches = phase_block_types(every, dev)
    phase_scan(every, dev)
    log(f"[time] phases 28-31 took {time.perf_counter() - t_m2:.1f} s")

    t_dp = time.perf_counter()
    world1_launches, world1_steps = phase_world1(every, dev, train_launches)
    phase_gloo(every)
    log(f"[time] phases 32-33 took {time.perf_counter() - t_dp:.1f} s")

    # ---- the webdataset source through the trainer
    wds_launches = phase_wds(every, dev, default_step)
    check(wds_launches == want_train,
          f"--data_set wds: {wds_launches} for {TRAIN_STEPS} steps, "
          f"{EVAL_BATCHES} evals")

    # ---- the model axis: tensor parallelism and sp on ranks of this card
    tp_launches, _ = phase_tp(every)
    lap("phase 35")

    # ---- ConvNeXt through the trainer, the golden and the server
    phase_convnext(every, dev, ckpt_dir)
    lap("phase 36")

    f64, f128 = kernel[MAIN_SHAPES[0]], kernel[MAIN_SHAPES[1]]
    g64, g128 = bwd[BWD_MAIN_SHAPES[0]], bwd[BWD_MAIN_SHAPES[1]]
    l1, l32 = long_k[LONG_MAIN_SHAPES[0]], long_k[LONG_MAIN_SHAPES[1]]
    m128, m64 = mlp_k[MLP_MAIN_SHAPES[0]], mlp_k[MLP_MAIN_SHAPES[1]]
    hp64, hp128 = hp_k[HP_MAIN_SHAPES[0]], hp_k[HP_MAIN_SHAPES[1]]
    fu64, fu128 = fu_k[FUSED_MAIN_SHAPES[0]], fu_k[FUSED_MAIN_SHAPES[1]]
    src = f"{PKG}/csrc/"
    jax_ops = "vision_transformers_torch_xla_tpu/ops/"

    def long_entry(name, source, replaces, library):
        return {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": jax_ops + replaces,
            "launches": long_train[f"{name.upper()}_LAUNCHES"],
            "max_abs_err": long_worst[name], "shape": LONG_MAIN_SHAPES[1],
            "ms": l32[f"{name}_ms"], "plain_ms": l32[f"{name}_plain_ms"],
            "bound_ms": l32[f"{name}_bound_ms"],
            "bound_by": l32[f"{name}_bound_by"],
            "library_ms": l32[library], "ms_b1": l1[f"{name}_ms"],
            "plain_ms_b1": l1[f"{name}_plain_ms"],
            "ms_s197_b64": long_k[(64, 197, 12, 64)][f"{name}_ms"],
            "ms_s197_b128": long_k[(128, 197, 12, 64)][f"{name}_ms"]}

    def hp_entry(name, source, replaces):
        return {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": jax_ops + replaces,
            "launches": hp_launches[f"{name.upper()}_LAUNCHES"],
            "max_abs_err": hp_worst[name], "shape": HP_MAIN_SHAPES[1],
            "ms": hp128[f"{name}_ms"], "plain_ms": hp128[f"{name}_plain_ms"],
            "bound_ms": hp128[f"{name}_bound_ms"],
            "bound_by": hp128[f"{name}_bound_by"],
            "library_ms": hp128[f"{name}_library_ms"],
            "ms_b64": hp64[f"{name}_ms"],
            "plain_ms_b64": hp64[f"{name}_plain_ms"]}

    def fused_entry(name, source, replaces):
        return {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": jax_ops + replaces,
            "launches": fu_launches[f"{name.upper()}_LAUNCHES"],
            "max_abs_err": fu_worst[name], "shape": FUSED_MAIN_SHAPES[1],
            "ms": fu128[f"{name}_ms"], "plain_ms": fu128[f"{name}_plain_ms"],
            "bound_ms": fu128[f"{name}_bound_ms"],
            "bound_by": fu128[f"{name}_bound_by"],
            "library_ms": fu128[f"{name}_library_ms"],
            "ms_b64": fu64[f"{name}_ms"],
            "plain_ms_b64": fu64[f"{name}_plain_ms"]}

    kernels = [{
        "name": "attn_fwd", "route": "cuda", "source": src + "attn_fwd_tc.cu",
        "replaces": jax_ops + "flash_attention.py:291",
        "launches": train_launches["ATTN_FWD_LAUNCHES"],
        "launches_serve": serve_launches, "max_abs_err": worst,
        "shape": MAIN_SHAPES[1], "ms": f128["ms"],
        "plain_ms": f128["plain_ms"], "bound_ms": f128["bound_ms"],
        "bound_by": f128["bound_by"], "library_ms": f128["library_ms"],
        "ms_b64": f64["ms"], "plain_ms_b64": f64["plain_ms"]}, {
        "name": "attn_bwd", "route": "cuda", "source": src + "attn_bwd_tc.cu",
        "replaces": jax_ops + "flash_attention.py:495",
        "launches": train_launches["ATTN_BWD_LAUNCHES"],
        "max_abs_err": bwd_worst, "shape": BWD_MAIN_SHAPES[1],
        "ms": g128["ms"], "plain_ms": g128["plain_ms"],
        "bound_ms": g128["bound_ms"], "bound_by": g128["bound_by"],
        "library_ms": g128["library_ms"], "ms_b64": g64["ms"],
        "plain_ms_b64": g64["plain_ms"]},
        dict(long_entry("flash_fwd", "flash_fwd.cu", "flash_blocked.py:33",
                        "sdpa_fwd_ms"), launches_serve=long_serve),
        long_entry("flash_bwd_dkdv", "flash_bwd.cu", "flash_blocked.py:109",
                   "sdpa_bwd_ms"),
        long_entry("flash_bwd_dq", "flash_bwd.cu", "flash_blocked.py:157",
                   "sdpa_bwd_ms"), {
        "name": "fc2_bwd", "route": "cuda", "source": src + "mlp_fused.cu",
        "replaces": jax_ops + "mlp_fused.py:65",
        "launches": mlp_train["FC2_BWD_LAUNCHES"],
        "max_abs_err": mlp_worst, "shape": MLP_MAIN_SHAPES[0],
        "ms": m128["ms"], "plain_ms": m128["plain_ms"],
        "bound_ms": m128["bound_ms"], "bound_by": m128["bound_by"],
        "library_ms": None, "unfused_ms": m128["unfused_ms"],
        "ms_b64": m64["ms"], "plain_ms_b64": m64["plain_ms"],
        "unfused_ms_b64": m64["unfused_ms"]},
        hp_entry("hp_fwd", "attn_fwd_tc.cu", "flash_attention.py:171"),
        hp_entry("hp_bwd", "hp_bwd_tc.cu", "flash_attention.py:212"),
        fused_entry("fused_fwd", "attn_fwd_tc.cu", "flash_attention.py:36"),
        fused_entry("fused_bwd", "hp_bwd_tc.cu", "flash_attention.py:61"),
        fused_entry("qkv_fwd", "attn_fwd_tc.cu", "flash_attention.py:740"),
        fused_entry("qkv_bwd", "hp_bwd_tc.cu", "flash_attention.py:764")]
    # one line for each fp32 and fp16 instantiation; every kernel in fp32 is
    # a CUDA-core one (fp16 K1-K12 share bf16's tensor-core sources). The fp32 K1, K2 and K3 count the
    # launches of the trainer's own run (main() --precision fp32, with
    # --pallas_mlp on for K3), the fp32 K4, K5 and K6 those of the 518-px
    # fp32 trainer (phase 17c); every other instantiation those of
    # drive_entry_points.
    sources = {k["name"]: k["source"] for k in kernels}

    def dtype_source(name, dt_name):
        # fp16: K4-K6 on csrc/flash_fwd.cu and flash_bwd.cu (bf16's
        # sources)
        cuda_core = {}
        if dt_name == "float32":
            cuda_core.update(attn_fwd="attn_fwd_simt.cuh",
                             attn_bwd="attn_bwd.cu",
                             flash_fwd="flash_fwd_simt.cu",
                             flash_bwd_dkdv="flash_bwd_simt.cu",
                             flash_bwd_dq="flash_bwd_simt.cu",
                             hp_fwd="attn_fwd_simt.cuh",
                             fused_fwd="attn_fwd_simt.cuh",
                             qkv_fwd="attn_fwd_simt.cuh",
                             hp_bwd="hp_bwd_simt.cu",
                             fused_bwd="hp_bwd_simt.cu",
                             qkv_bwd="hp_bwd_simt.cu")
        return src + cuda_core[name] if name in cuda_core else sources[name]

    replaces = {k["name"]: k["replaces"] for k in kernels}
    # the fp32 K1, K9 (register tiles around csrc/cc_tiles.cuh) and K3,
    # redesigned in place of the kernels their sources held before, the
    # fp32 K4, K5 and K6 of csrc/flash_fwd_simt.cu and flash_bwd_simt.cu,
    # and the fp32 K8, K10 and K12 of csrc/hp_bwd_simt.cu
    hp_simt = ["hp_bwd_stats_simt_kernel<64, 128, 2>",
               "hp_bwd_dkdv_simt_kernel<64, 128, 2>", "hp_bwd_dq_sum_kernel"]
    simt = {"attn_fwd": ["attn_fwd_simt_kernel<64, false, true>"],
            "hp_fwd": ["attn_fwd_simt_kernel<64, false, true>"],
            "fused_fwd": ["attn_fwd_simt_kernel<64, true, true>"],
            "qkv_fwd": ["attn_fwd_simt_kernel<64, true, true>"],
            "fc2_bwd": ["fc2_bwd_simt_kernel"],
            "flash_fwd": ["flash_fwd_simt_kernel<64>"],
            "flash_bwd_dkdv": ["flash_bwd_dkdv_simt_kernel<64, 128, 2>"],
            "flash_bwd_dq": ["flash_bwd_dq_simt_kernel<64, 128, 2>"],
            "hp_bwd": hp_simt, "fused_bwd": hp_simt, "qkv_bwd": hp_simt}
    # the trainer runs whose launches the fp32 lines count: phase 22's on
    # my_vit_s, phase 17c's at 518 px
    trainer_runs = {
        ("float32", "attn_fwd"): (f"main() {' '.join(PRECISION_RUNS['fp32'])}",
                                  prec["fp32"]),
        ("float32", "attn_bwd"): (f"main() {' '.join(PRECISION_RUNS['fp32'])}",
                                  prec["fp32"]),
        ("float32", "fc2_bwd"): (
            f"main() {' '.join(PRECISION_RUNS['fp32_mlp'])}",
            prec["fp32_mlp"])}
    for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
        trainer_runs[("float32", name)] = (
            f"main() {' '.join(LONG_FP32_FLAGS)}", long32)
    # the tensor-core K4, K5 and K6 (phase 17d): the edges' worst error, and
    # at D 256 the times at (32, 1370, 12, 256) (the fp32 K4 and K5's,
    # phase 17e's)
    def tc_blocked(dt_name, name, shape, suffix=""):
        row = tc_rows.get((dt_name, name, shape))
        if row is None:
            return {}
        if not suffix:
            # phase 17d's edges, over the largest plain magnitude
            return {"max_rel_err_edges": tc_worst[(dt_name, name)]}
        return {f"{key}{suffix}": row[key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}

    for dt_name in DTYPES:
        for name in DTYPE_SHAPES:
            row = dt_rows[(dt_name, name)]
            path, launched = trainer_runs.get(
                (dt_name, name), ("drive_entry_points", dt_launches[dt_name]))
            kernels.append({
                "name": f"{name}[{dt_name}]", "route": "cuda",
                "source": dtype_source(name, dt_name),
                "replaces": replaces[name],
                "dtype": dt_name, "path": path,
                "launches": launched[f"{name.upper()}_LAUNCHES"],
                "launches_entry_points":
                    dt_launches[dt_name][f"{name.upper()}_LAUNCHES"],
                "max_abs_err": dt_worst[(dt_name, name)],
                "shape": row["shape"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                **({"unfused_ms": row["unfused_ms"]} if "unfused_ms" in row
                   else {}),
                **({"kernels": simt[name]} if dt_name == "float32"
                   and name in simt else {}),
                **tc_blocked(dt_name, name, row["shape"])})
    # one line for each kernel at a head dim of 256 in each dtype (the wide
    # tensor-core tiles in bf16 and fp16; fp32 on the CUDA cores), counting
    # the launches of drive_wide_heads
    for dt_name in WIDE_DTYPES:
        for name in WIDE_KERNELS:
            row = wide_rows[(dt_name, name)]
            d = row["shape"][3]
            names = wide_kernel_names(name, dt_name, d)
            wide_src = "attn_bwd_tc.cu" if names[0].startswith(
                "attn_bwd_tc") else \
                "attn_bwd_simt.cu" if names[0].startswith(
                    "attn_bwd_rows_simt") else \
                "attn_bwd.cu" if name == "attn_bwd" else \
                "flash_fwd.cu" if names[0].startswith("flash_fwd_kernel") \
                else "flash_bwd.cu" if names[0].startswith(
                    ("flash_bwd_dkdv_kernel", "flash_bwd_dq_tc_wide")) else \
                "flash_fwd_simt.cu" if names[0].startswith(
                    "flash_fwd_wide_simt") else \
                "flash_bwd_simt.cu" if names[0].startswith(
                    ("flash_bwd_dkdv_wide_simt", "flash_bwd_dq_wide_simt")) \
                else \
                "flash_blocked.cu" if name.startswith("flash") else \
                "attn_fwd_tc.cu" if names[0].startswith("attn_fwd_tc") else \
                "hp_bwd_tc.cu" if names[0].startswith("hp_bwd_tc") else \
                "attn_fwd_simt.cuh" if names[0].startswith(
                    "attn_fwd_simt") else \
                "attn_fwd.cu" if names[0].startswith("attn_fwd") else \
                "fused_attn_fwd.cu" if names[0].startswith("fused") else \
                "hp_bwd_simt.cu" if "_simt_" in names[0] else \
                "hp_bwd.cu"
            kernels.append({
                "name": f"{name}[{dt_name},d{d}]", "route": "cuda",
                "source": src + wide_src, "replaces": replaces[name],
                "dtype": dt_name, "head_dim": d, "path": "drive_wide_heads",
                "kernels": names,
                "launches": wide_launches[dt_name][
                    f"{name.upper()}_LAUNCHES"],
                "max_abs_err": wide_worst[(dt_name, name)],
                "shape": row["shape"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"],
                **tc_blocked(dt_name, name, row["shape"]),
                **tc_blocked(dt_name, name, (32,) + row["shape"][1:2]
                             + (12, 256), "_b32")})
    # the launches of the rest of the ViT's main() runs (phases 28-30)
    for k in kernels[:5]:
        count = f"{k['name'].upper()}_LAUNCHES"
        if k["name"].startswith("flash"):
            k["launches_reg4"] = reg4_runs[False][count]
            k["launches_reg4_remat"] = reg4_runs[True][count]
        else:
            k["launches_siglip"] = siglip_launches[count]
            k["launches_block_types"] = {n: v[count] for n, v in
                                         block_launches.items()}
            # phase 32's main() under DDP and FSDP2 over a world-1 group
            k["launches_ddp"] = world1_launches["ddp"][count]
            k["launches_fsdp"] = world1_launches["fsdp"][count]
            # phase 34's main() on webdataset shards
            k["launches_wds"] = wds_launches[count]
    # phase 35's split runs, rank 0's launches (their checked steps and
    # the timed one), for the kernels each run launches
    for k in kernels[:6]:
        count = f"{k['name'].upper()}_LAUNCHES"
        for run, n in tp_launches.items():
            if n[count]:
                k[f"launches_{run}"] = n[count]
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel of the path never launched: "
          f"{[(k['name'], k['launches']) for k in kernels]}")
    log(f"[device] nvidia-smi: {nvidia_smi()}")
    log(f"[done] chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
