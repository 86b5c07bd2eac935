#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero):

  1. build — compile every CUDA kernel from ``src/repro_torch/kernels/
     csrc`` with nvcc for sm_90a (one nvcc per source, in parallel) and
     print the card's name and power limit;
  2. kernel vs plain — each kernel against its plain PyTorch version on
     the card, bit for bit (``torch.equal`` on the int32 outputs, and on
     the f32 results of the fused kernels after the eager epilogue), at
     every shape the main paths give it: shared and banked activations,
     the 17-table case-study bank, the mixed-width wide-study bank
     (8/12/16-bit lanes; K6 with per-lane codes as the study gives it)
     in its own lane order, with the wide lanes first and with narrow
     and wide lanes interleaved, a bank mixing exact/trunc/loa trees
     (K8, and K6 with a reduce code per lane), ragged shapes, shapes at
     which one lane's K is split into ranges (``SPLIT``: the deep layers,
     a ragged K with a short last range), K3/K4 at their staging's ragged
     edges (``QUANT8_RAGGED``: N <= 8, K in {1, 31, 33, 577}, M in {1,
     513}, activations shared and banked) and a table
     with LUT[0,0] != 0; the population simulator (K11) at the CGP ladder's
     population (32 candidates, 8192 vectors) for the 8-bit multiplier
     and adder, and K11 and K10 on every walk of ``bitsim.walk_plan``
     (a 1000-gate chain and the exact multiplier on the level walk, a
     netlist of 1806 signals reading its gates from device memory,
     mutants of both seeds at ragged word counts); the low-rank kernel (K9), whose f32 sums run in another
     order than its plain version's, held with its plain version to the
     bound |y - y64| <= 2 (K R + 1) 2^-24 S (y64 the sum in float64,
     S = sum_r |U_r(qa)| @ |V_r(qw)|) at the serve path's shapes
     (M = 128 prefill on its 3xTF32 tensor-core regime and 4 decode on
     its streaming split-K regime; (K, N) of every projection of
     qwen1.5-0.5b) and ragged ones, with the served multiplier's factors
     at rank 4 and at its auto rank, and a second call on the same
     inputs bit-equal to the first (its split K sums in a fixed order);
     K9's max |K9 - y64| / bound is recorded per case, with the shape,
     regime, rank and the y64 and S of the worst element; K2 and K4 at
     the continuous serving step's shapes (``CONTINUOUS_*``: lanes
     gathered from the serve-load benchmark's 8-table bank, P = 1 and 4,
     M = 1 and 8, the three (K, N) of qwen1.5-0.5b's projections); K1-K4
     at the module-profile sweeps' full-width shapes (``PROFILE_STEP``:
     P = 15 lanes of M = 4 capacity rows at qwen3-moe's expert
     projections, P = 6 lanes of 16 rows at mamba2's in/out projections;
     ``PROFILE_STEP_CHECK``: M = 3 000 rows a lane at whisper's encoder
     projections, P = 24 lanes of 4 rows at deepseek's experts);
  3. main paths, each with the launch counters zeroed just before it and
     read just after: the full-width ResNet-8 case study under
     ``variant="pallas"`` (K1/K2) and ``variant="fused"`` (K3/K4), whose
     accuracies must be equal list for list; the wide-width Pareto study
     (``repro_torch.launch.wide_pareto``) under ``"fused"`` (K3/K7/K8)
     and ``"pallas"`` (K1/K5/K6), each failing unless its two gates
     hold, and the pallas rows must equal the fused ones; the
     heterogeneous per-layer DSE (``repro_torch.launch.
     heterogeneous_pareto``: the uniform Table II sweep, then
     ``explore_heterogeneous`` — per-layer sweep, beam, batched
     verification through ``policy_bank_eval`` — the equal-assignment
     check and batched against sequential verification, 8 + 3
     multipliers at 256 images) under ``"pallas"`` (K1/K2) and
     ``"fused"`` (K3/K4), failing unless its equal-assignment and
     verification gates hold, the batched verification launched K2 (K4)
     exactly once a layer and eval batch and nothing else, and the fused
     rows, verified points and selection equal the pallas ones (the
     dominance gate's result at this size is printed and recorded);
     then the reference's recorded ``--quick`` form (64 images, 12 + 3
     multipliers) under ``"pallas"``, failing unless all three gates,
     dominance included, hold and its multipliers, uniform points,
     verified assignments, selection and dominating point equal the
     reference's recorded run (``benchmarks/results/
     BENCH_heterogeneous.json``; accuracies within one image); then a
     policy bank mixing 8-bit and composed 12/16-bit lanes over the
     ResNet-8 layers on one batch, whose logits under ``"pallas"`` (K6)
     and ``"fused"`` (K8) must equal the plain datapath's, and an 8-bit
     policy bank at the study's lane count, with repeated lanes, whose
     logits under K2 and K4 must too, each one launch a layer; the
     surrogate-guided DSE against the exact-sweep DSE
     (``repro_torch.launch.dse_surrogate``: 108 candidates, the 57
     8-bit multipliers of the library widened by 51 broken-array ones on
     a new library instance, ResNet-8 under ``classification(
     fidelity=True)``, the surrogate path first — per-layer sweep of 27
     circuits, the MLP fit as a replayed CUDA graph, beam, batched
     verification — then the exact path's 108-circuit sweep, beam and
     verification) at the reference's recorded ``--quick`` size (32
     images) under ``"pallas"`` (K2) and ``"fused"`` (K4) and at its
     default (64 images) under ``"pallas"``, failing unless the fidelity
     gate (mean per-layer Spearman >= 0.9 on the unseen circuits) holds,
     243 / 972 cells were measured, each path launched the banked kernel
     exactly 2 x 9 x eval batches times and nothing else, and the
     captured fit equals the eager fit bit for bit; the speedup gate (a
     wall-clock ratio) and the front gate, which the JAX reference
     misses too at both sizes, are printed and recorded, a front miss at
     ``--quick`` held to within 0.01 in logit_mae; the ``--quick``
     pallas run must equal the reference's recorded run
     (``benchmarks/results/BENCH_dse.json``: counts, training circuits,
     evaluations, selections; logit_mae within 0.01 where the fronts
     share a point; its exact front printed beside the record's) and
     fused must equal pallas; the default library keeps its entries; then
     one per-layer pass over the 108 candidates at one layer and batch,
     whose logits under K2 and K4 must equal the plain datapath's with
     one launch; the circuit
     library evolved on the card (``repro_torch.core.build_library``,
     budget ``small``, ``engine="device"``: K11 scores every generation,
     K10 re-verifies each search's final circuit), then the ``tiny``
     build under ``engine="device"`` on the card and ``"numpy"`` on the
     host, which must be equal; the serve path
     (``repro_torch.launch.serve.run``: qwen1.5-0.5b at full width,
     batch 4, prompt 32, 16 new tokens, ``mode="lowrank"``, rank 4, the
     auto-picked multiplier, ``variant="pallas"``), which must launch K9
     7 x 24 times per forward, keep every K9 call of one prefill and one
     decode step within the bound of its plain version on the same
     codes, and agree with the same model under ``variant="ref"``
     within the CPU tests' logit tolerance (teacher-forced), with one
     decode step profiled; fails unless every kernel ran, and unless
     the CUDA datapaths' banked logits equal the plain datapath's;
  4. K10 against ``Netlist.eval_words`` and its plain version on
     exhaustive planes (65 536 vectors) for every evolved netlist of the
     built library;
  5. the expert axis of K1-K4 (``phase_experts``): one launch for an MoE
     projection's experts and bank lanes, bit for bit against the plain
     versions at E = 8 with qwen3-moe's and deepseek's expert projections
     (M = 4, P = 1 and 3, activations banked and shared) and at ragged
     shapes (two token blocks' buffers over the same experts among
     them), then at full E (P = 15 x E = 128 at qwen3-moe's (2048, 768),
     P = 24 x E = 160 at deepseek's (5120, 1536)) against E launches of
     K2/K4 without the axis, bit for bit, each timed beside its bound;
     K4's expert form at the benchmark's qwen3-moe cell (``EXPERT_CELL``:
     8 lanes x 128 experts, C = 80 capacity rows, 2048 -> 768 and 768 ->
     2048; ``phase_experts_cell``, callable alone on another tree's
     ``src/`` to time its kernel in the same call), timed beside its
     bound and its tile, two pairs held to the plain version;
     then timings — each kernel and its plain version at the main-path
     shapes (CUDA events after warm-up) beside its bound, the largest of
     its table lookups, its integer ops and its bytes (K9 also beside
     ``torch.matmul`` of its pre-gathered tables, its ``library_ms``, with
     its regime and grid; K1-K8 with their items and K ranges,
     ``fused_matmul.k_split``; K3/K4 also by their launch alone,
     ``launch_ms``, its device time from ``torch.profiler``,
     ``device_ms``, and by the device work one call through
     ``kernels.ops`` queues, ``kernels_per_call`` from ``torch.profiler``,
     which fails above two for K3: its kernel and, where K is split, one
     memset); K10/K11 likewise (launch alone, device time, one device
     op a call) with their walk, level depth and depth floor (depth x
     one level's wait, ``bitsim.probe_round_ms``), and a CGP
     generation's wall split into host time and the time from its
     operands on the card to its scores on the host;
  6. the continuous-batching mixed-policy serving path, with the launch
     counters zeroed just before each run and read just after (it runs
     after the timing phase: with its ~2.5 million launches before them,
     the timing phase's short profiler windows lost most of their kernel
     records): ``repro_torch.launch.serve_load.run(quick=True)`` at the
     full width of qwen1.5-0.5b under ``"pallas"`` (K2) and ``"fused"``
     (K4): 3 levels of 1/2/4 policies, 8 Poisson-arriving requests
     each, 4 slots, failing unless every request's tokens equal the
     sequential ``Engine.generate`` replay (K1/K3), the banked kernel
     launched exactly 7 x 24 times a prefill and a decode step and
     nothing else, the bank was built once, the decode steps and
     requests a level equal the reference's recorded ``benchmarks/
     results/BENCH_serve.json`` and fused tokens equal pallas tokens;
     then ``launch.serve.run(continuous=True)`` at the CLI defaults, K2
     168 a prefill and a decode step; then one decode step with 4 slots
     and 4 policies under ``torch.profiler`` (wall, device busy,
     kernels beside the host's launch calls);
  7. the module-resilience profiles of the LM zoo, after the timing phase
     too, each run with the launch counters zeroed just before it and
     read just after: ``repro_torch.launch.arch_profiles.run(quick=
     True)`` under ``"pallas"`` (K2, K1) and ``"fused"`` (K4, K3), failing
     unless its four gates hold (coverage, selection, bit identity, and
     the banked calls of the identity sweeps equal to the formula), its
     five archs (whisper-large-v3's encoder-decoder among them), each
     one's modules, module shares and row count and the multipliers
     equal the reference's recorded run (``benchmarks/results/
     BENCH_profiles.json``; the selections are printed beside the
     record's) and fused rows equal pallas rows; then ``run(quick=False)``
     under ``"pallas"``, the eight reduced archs (deepseek-v2-236b's MLA
     and llava-next-34b's image path among them) and ResNet-8, failing
     unless its four gates hold; then, through the library API, at full
     width with random weights on the card at the configs' dtype:
     mamba2-780m (48 layers), qwen3-moe-30b-a3b (2 of 48 layers),
     whisper-large-v3 (4 + 4 of 32 + 32 layers, all 1 500 frames) and
     deepseek-v2-236b (1 of 60 layers): each profile's stage walls,
     banked launches a sweep, peak memory and selection, failing unless
     the banked sweep of every row equals the sequential evaluation bit
     for bit, the banked kernel launched exactly the formula's count
     (96, 14, 64 and 14 a sweep: one a projection, a routed-expert
     projection one for all its experts) and fused rows equal pallas rows,
     with one banked sweep of each under ``torch.profiler`` (device
     busy, kernels); then K2 and K4 timed at those sweeps' shapes beside
     their bounds;
  8. the encoder-decoder serve path: ``launch.serve.run(arch=
     "whisper-large-v3")``, the whole model (32 + 32 layers, 1 500 stub
     audio frames) at full width under the serve path's settings, which
     must launch K9 512 times a prefill and 256 a decode step (9 728 in
     the run), keep every K9 call of one prefill and one decode step
     within the bound of its plain version, and agree with the same
     model under ``variant="ref"`` within the logit tolerance
     (teacher-forced); its prefill and decode rates, one profiled decode
     step and the model's bytes are printed;
  9. continuous serving of every family (``phase_serve_families``),
     each run with the launch counters zeroed just before it and read
     just after: ``launch.serve_load.run`` (one level of 4 Poisson
     requests, 2 policies, greedy and sampled, 4 slots) under
     ``"pallas"`` (K2) on mamba2-780m and whisper-large-v3 whole (1 500
     stub frames), qwen3-moe-30b-a3b with 4 of 48 layers,
     deepseek-v2-236b with 1 of 60 (and under ``"fused"``, K4, whose
     tokens must equal pallas's), jamba-v0.1-52b and llava-next-34b
     reduced, and qwen1.5-0.5b with chunked attention (4 keys a chunk),
     each failing unless every request's tokens equal its sequential
     ``Engine.generate`` (K1 / K3), every prefill and decode step
     launched the banked kernel exactly the call-site formula's count
     (``serve_load.banked_calls_per_step``) and nothing else, and the
     bank was built once; each run's wall, tokens/s and decode step
     wall printed; one deepseek decode step (4 slots) under
     ``torch.profiler``, with the share of a step the latent expansion
     (``wuk``/``wuv``) takes; then deepseek-v2-236b (1 of 60 layers)
     served statically under ``lowrank``/``pallas`` (``_serve_path``:
     K9 14 times a prefill and a decode step, a routed-expert
     projection one launch for its 160 experts, every K9 call of a
     prefill and a step within the bound, per slice of the expert form,
     logits within the tolerance of ``variant="ref"``);
 10. training (``phase_train``), its checkpoints in a temporary
     directory removed at the end: ``launch.train_resnet.train``, the
     recipe of the committed ResNet-8 (320 f32 steps at batch 64 from a
     seeded init), whose losses must be finite and fall, its float and
     8-bit accuracy beside the committed checkpoint's; then
     ``train_resnet.run(from_checkpoint=True)`` under ``"pallas"`` and
     ``"fused"`` (Table II, Fig. 4, the heterogeneous DSE, the STE
     fine-tune), failing unless the fine-tune launched K1 (K3) exactly
     once an assigned layer a step and each evaluation once an assigned
     layer a batch, and nothing else; one STE step under that policy
     whose every matmul output equals its plain datapath's and whose
     every weight gradient equals ``torch.matmul(x2d.T, g)`` bit for
     bit; ``launch.train.run`` on qwen1.5-0.5b at full width (10 steps,
     batch 8 x 128, remat on), whose losses must be finite and fall,
     then a resume into fresh tensors equal to the saved parameters and
     optimizer state bit for bit; a banked ``lm_perplexity`` sweep on
     reduced qwen1.5-0.5b equal to the sequential one bit for bit, the
     banked kernel launched once a projection a pass;
 11. the objectives study (``launch.objectives_pareto``) at ``--quick``
     under both variants, against the reference's recorded
     ``benchmarks/results/BENCH_objectives.json`` (candidates, the 2-D
     gate, both fronts' members, accuracies within one image, the
     selection), its launches equal to the call-site formula and the
     fused rows to the pallas rows, then at 256 images;
 12. the evolve study (``launch.evolve_library``) at its default size
     against ``benchmarks/results/BENCH_evolve.json`` (metric identity,
     the ladder, the tiny builds' counts); its throughput ratio is
     recorded, not gated;
 13. lane sharding (``phase_mesh``) over ``launch.mesh.sweep_mesh()``
     (the card the run has) and a two-entry mesh that lists that card
     twice — it exercises the split, the per-shard launches and the
     gather on one card, and measures nothing across cards — each path
     sharded against unsharded, with the launch counters zeroed just
     before each run and read just after: the case study's all-layers
     sweep on ResNet-8 (the committed checkpoint, 256 images in 64-image
     batches) with a 16-multiplier bank split 8 + 8, its 17-multiplier
     bank (no split: whole on the first device) and the 16 lanes on
     ``sweep_mesh()``, under ``"pallas"`` (K2) and ``"fused"`` (K4); the
     wide study's 12-lane mixed-width bank split 6 + 6 (K6 / K8); the
     heterogeneous study's batched verification of its assignments with
     ``assign_sharding``; one mul8 CGP generation (32 offspring) and a
     short ladder on the device engine with ``pop_sharding`` (K11; K10
     re-verifies); ``ContinuousEngine(sharding=slot_sharding(4, ...))``
     serving qwen1.5-0.5b at full width (random weights from seed 0) to
     4 Poisson requests of 16 new tokens (K2; the replay K1); and
     ``compressed_psum`` over an NCCL group of world size 1.  Each fails
     unless sharded equals unsharded bit for bit (rows, scores,
     trajectories, tokens; the tokens also the sequential replay's), each
     banked call launched its kernel once a shard with that shard's lanes
     and nothing else ran, and the all-reduce equals its plain formula;
     the phase's wall and each path's sharded and unsharded walls are
     printed;
 14. the dry run (``phase_dryrun``, ``repro_torch.launch.dryrun``):
     first on the host, the production (16, 16) mesh as a ``"fake"``
     process group of 256 with every leaf a DTensor over ``meta``
     shards, ``qwen1.5-0.5b`` x ``train_4k`` and x ``decode_32k`` and
     ``mamba2-780m`` x ``long_500k`` (each must be ``ok`` with a nonzero
     collective term; per-device argument GB, flops, collective GB, the
     roofline terms on the H100's published peaks and the bottleneck
     printed); then the same cells on a one-card mesh, whose probes run
     for real on the card from seed 0 — the train cell's one 1 x 4096
     microbatch forward and backward at one and two layers and the
     optimizer at full depth, ``decode_32k``'s batch of 128 against a
     32 768-row cache (17.2 GB of bf16 KV a layer) and ``long_500k``'s
     batch of 1, each at one and two layers, under ``"pallas"`` (K9) and
     ``"ref"``.  Fails unless each one-card analysis is ``ok`` with no
     collectives, K9 launched exactly 7 (qwen1.5-0.5b) or 2 (mamba2) a
     layer in each decode probe's timed run, and each decode probe's
     logits under ``"pallas"`` are within ``QUANT_RTOL`` of the largest
     |logit| of the same probe under ``"ref"``; each probe's wall and
     peak memory are printed beside its roofline bound and the card's
     name and power limit.

The line before last is the kernels' JSON summary, the last line the
device JSON.  Details go to ``chiprun_out/chip_smoke.json``.  Without a
CUDA device, or without the repository's ``src/`` beside it, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
sys.path.insert(0, os.path.join(ROOT, "src"))

EVAL_N, BATCH, N_LANES = 256, 64, 17
LIBRARY_BUDGET = "small"
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s; shared-memory table
# lookups per SM per clock (one 32-lane LDS a clock, no bank conflicts);
# INT32 ops per SM per clock on the ALU pipe (logic, adds, shifts), and
# as many again on the FMA pipe (IMAD: adds, shift-adds) beside it
HBM_BYTES_PER_S = 3.35e12
LOOKUPS_PER_SM_CLOCK = 32
INT32_OPS_PER_SM_CLOCK = 64
RAGGED = ((1000, 37, 10), (777, 100, 50), (129, 577, 65), (1, 1, 1))
# shapes at which a single lane's K is split into ranges (the gather
# body's k_splits): the two deep layers, a ragged K whose last range is
# short, and many ranges with a one-code last chunk
SPLIT = ((4096, 576, 64), (4096, 288, 64), (4096, 100, 64), (512, 577, 64))
# K3/K4 at the ragged edges of their staging: one column tile of one
# thread across N (N <= 8: 512-row tiles), K of one code, one short of a
# chunk, one past it and many chunks with a one-code last, one row and
# one past a row tile
QUANT8_RAGGED = tuple((m, k, n) for m in (1, 513) for k in (1, 31, 33, 577)
                      for n in (1, 8))
# the heterogeneous study's kernels under each variant (the single-lane
# kernel runs the sequential evaluations), and its banked kernel, which
# the batched verification must launch once a layer and eval batch
HETERO_KERNELS = {"pallas": ("lut_matmul", "lut_matmul_bank"),
                  "fused": ("fused_matmul", "fused_matmul_bank")}
# the JAX reference's recorded run of the study's --quick configuration
BENCH_HETEROGENEOUS = os.path.join(ROOT, "benchmarks", "results",
                                   "BENCH_heterogeneous.json")
# the surrogate-guided DSE: its banked kernel under each variant, the
# JAX reference's recorded --quick run, the (layer, circuit) cells each
# path measures (27 and 108 circuits x 9 layers), the layer of the
# 108-lane pass check (its largest per-layer pass: 32 768 rows x 144)
# and the logit_mae tolerance against the reference that
# tests/test_torch_dse_surrogate.py states (LOGIT_MAE_ATOL)
DSE_KERNEL = {"pallas": "lut_matmul_bank", "fused": "fused_matmul_bank"}
# the single-table kernel of each variant (the sequential evaluations)
PROFILE_SINGLE = {"pallas": "lut_matmul", "fused": "fused_matmul"}
PROFILE_STAGES = ("setup_s", "baseline_s", "sweep_s", "compose_s",
                  "verify_s")
BENCH_DSE = os.path.join(ROOT, "benchmarks", "results", "BENCH_dse.json")
DSE_CIRCUITS = 108
DSE_EVALS = (27 * 9, DSE_CIRCUITS * 9)
DSE_LAYER = "s0_b0_conv1"
LOGIT_MAE_ATOL = 0.01
# gates of the surrogate-guided DSE recorded rather than failed: the
# speedup gate (a wall-clock ratio the reference took on its CPU) and the
# front gate, which the JAX reference misses as the port does (PERF.md
# §6): at 64 images its own benchmark misses it on the same
# candidate, at --quick its decision logic and verification on the rows
# measured on the card miss it on the same point (there a miss must stay
# within LOGIT_MAE_ATOL)
DSE_RECORDED_GATES = ("speedup", "front")
# a policy bank mixing 8-bit and composed wide lanes (loa4, the wide
# study's tree): its kernel under each variant
POLICY_BANK_NARROW = ("mul8u_trunc6", "mul8u_bam_h0_v4")
POLICY_BANK_KERNEL = {"pallas": "composed_matmul_bank",
                      "fused": "fused_composed_matmul_bank"}
# composed entries of a bank that mixes reduction trees (K8 compare)
MIXED_REDUCE = (("mul8u_exact", 16, "trunc3"), ("mul8u_trunc6", 12, "exact"),
                ("mul8u_exact", 16, "loa4"))

SOURCES = {
    "lut_matmul": ("lut_matmul.cu", "approx_matmul.py:55"),
    "lut_matmul_bank": ("lut_matmul_bank.cu", "lut_bank.py:63"),
    "fused_matmul": ("fused_matmul.cu", "fused_matmul.py:446"),
    "fused_matmul_bank": ("fused_matmul_bank.cu", "fused_matmul.py:487"),
    "fused_composed_matmul": ("fused_composed_matmul.cu",
                              "fused_matmul.py:539"),
    "fused_composed_matmul_bank": ("fused_composed_matmul_bank.cu",
                                   "fused_matmul.py:590"),
    "composed_matmul": ("composed_matmul.cu", "composed_matmul.py:118"),
    "composed_matmul_bank": ("composed_matmul_bank.cu",
                             "composed_matmul.py:158"),
    "bitsim": ("bitsim.cu", "bitsim.py:73"),
    "bitsim_pop": ("bitsim_pop.cu", "bitsim.py:149"),
    "lowrank_matmul": ("lowrank_matmul.cu", "lowrank_matmul.py:48"),
}

# the serve path: qwen1.5-0.5b at full width, every projection on the
# auto-picked multiplier through the rank-4 factored LUT (kernel K9)
SERVE = {"arch": "qwen1.5-0.5b", "batch": 4, "prompt_len": 32,
         "max_new": 16, "mode": "lowrank", "multiplier": "auto", "rank": 4}
# K9 per forward: 7 projections (wq, wk, wv, wo, wi, wg, ffn.wo) a layer
PROJECTIONS_PER_LAYER = 7
# the logit tolerance tests/test_torch_lm.py states for the quantized
# policies, relative to the largest |logit| (about twice the reference's
# own lowrank vs lowrank_pallas spread)
QUANT_RTOL = 0.025
# K9 at the serve path's shapes: M = batch x prompt (prefill) or batch
# (decode); (K, N) of each projection of qwen1.5-0.5b
LOWRANK_SHAPES = {"prefill attn": (128, 1024, 1024),
                  "prefill ffn.wi/wg": (128, 1024, 2816),
                  "prefill ffn.wo": (128, 2816, 1024),
                  "decode attn": (4, 1024, 1024),
                  "decode ffn.wi/wg": (4, 1024, 2816),
                  "decode ffn.wo": (4, 2816, 1024)}
LOWRANK_RAGGED = ((129, 577, 65), (7, 130, 1), (1, 1, 1))
# the continuous serving step's K2/K4 shapes: the serve-load benchmark's
# 8-table bank, P lanes (1 at a prefill, up to 4 active slots at a decode
# step), M rows a lane (1 at decode, a prompt at prefill), and (K, N) of
# each projection of qwen1.5-0.5b
CONTINUOUS_LANES = {1: (2,), 4: (0, 3, 5, 7)}
CONTINUOUS_ROWS = (1, 8)
CONTINUOUS_KN = ((1024, 1024), (1024, 2816), (2816, 1024))
# the JAX reference's recorded serve-load run (--quick): decode steps and
# requests a level, which the port's schedule must reproduce
BENCH_SERVE = os.path.join(ROOT, "benchmarks", "results", "BENCH_serve.json")
# the continuous engine's kernels under each variant: banked, single-table
# (the sequential replay's)
CONTINUOUS_KERNELS = {"pallas": ("lut_matmul_bank", "lut_matmul"),
                      "fused": ("fused_matmul_bank", "fused_matmul")}
# the module-resilience profiles (``launch.arch_profiles``): the
# reference's recorded ``--quick`` run, and four families at full width,
# each with the depth cuts it needs (qwen3-moe: 48 layers of 128 experts
# are ~29 B parameters, more than one card holds in f32, and 2 of them
# keep the run's time beside the every-family serving phase; deepseek:
# one layer of its 160 experts is already ~3.8 B; whisper: 4 + 4 of its
# 32 + 32 layers keep the run's time, at all 1 500 encoder frames)
BENCH_PROFILES = os.path.join(ROOT, "benchmarks", "results",
                              "BENCH_profiles.json")
PROFILE_FULL_WIDTH = (("mamba2-780m", "ssm", {}),
                      ("qwen3-moe-30b-a3b", "moe", {"n_layers": 2}),
                      ("whisper-large-v3", "encdec",
                       {"n_enc_layers": 4, "n_layers": 4}),
                      ("deepseek-v2-236b", "moe", {"n_layers": 1}))
# the profile sweeps' K2/K4 shapes: (lanes, rows, K, N) of the MoE's
# expert projections (5 families x 3 multipliers, capacity 4 rows) and of
# mamba2's in/out projections (2 x 3 lanes, 2 x 8 tokens), full width;
# then whisper's encoder projections (7 x 3 lanes of 2 x 1 500 frames:
# attention, FFN up, FFN down) and deepseek's expert projections (8 x 3
# lanes, capacity 4 rows), timed with fewer repetitions
PROFILE_STEP = ((15, 4, 2048, 768), (15, 4, 768, 2048),
                (6, 16, 1536, 6448), (6, 16, 3072, 1536))
PROFILE_STEP_LARGE = ((21, 3000, 1280, 1280), (21, 3000, 1280, 5120),
                      (21, 3000, 5120, 1280), (24, 4, 5120, 1536),
                      (24, 4, 1536, 5120))
# the same sweeps' shapes held against the plain versions: whisper's
# 3 000 rows a lane at 2 lanes (the plain gather's time), deepseek's
# expert projections at all 24
PROFILE_STEP_CHECK = ((2, 3000, 1280, 1280), (24, 4, 5120, 1536),
                      (24, 4, 1536, 5120))
# the expert axis of K1-K4 (``phase_experts``: an MoE projection's E
# experts, for every bank lane, in one launch): (lanes P, experts E, rows
# M, K, N).  Held against the plain versions at E = 8 with qwen3-moe's and
# deepseek's expert projections at M = 4 capacity rows, one lane (K1/K3
# on one table; K2/K4 with a bank of one) and three (K2/K4, activations
# banked and shared), and at ragged shapes (the last: two token blocks'
# buffers over the same experts, X = 2E slices); then at full E against E
# launches of the kernels without the axis (kernel against kernel: the
# plain gather would take minutes at 160 experts) and timed beside them
EXPERT_CHECK = ((1, 8, 4, 2048, 768), (3, 8, 4, 2048, 768),
                (1, 8, 4, 768, 2048), (3, 8, 4, 768, 2048),
                (1, 8, 4, 5120, 1536), (3, 8, 4, 5120, 1536),
                (1, 8, 4, 1536, 5120), (3, 8, 4, 1536, 5120))
EXPERT_RAGGED = ((2, 5, 7, 577, 65), (3, 3, 1, 33, 9), (1, 4, 513, 31, 8),
                 (2, 3, 2, 100, 50))
EXPERT_BLOCKS = 2            # the last ragged case: X = 2E slices
EXPERT_FULL = ((15, 128, 4, 2048, 768), (24, 160, 4, 5120, 1536))
# K4's expert form as the benchmark's qwen3moe.ppl_fused cell runs it:
# (lanes, experts, capacity rows C = ceil(1024 x 8 / 128 x 1.25), K, N)
EXPERT_CELL = ((8, 128, 80, 2048, 768), (8, 128, 80, 768, 2048))
# the expert form of K9 and K5-K8 (``phase_experts``): (E experts, rows
# C, K, N).  K9 at E = 8 with deepseek's expert projections at C = 4 and
# 6 capacity rows (its decode and prefill: the streaming regime) and 64
# (the tensor-core regime), at ragged shapes (the last: two token blocks'
# buffers over the same experts), each slice within the bound of its
# plain version; then at deepseek's full E = 160, C = 4 against 160
# launches without the axis (kernel against kernel), both timed.  K5-K8
# at E = 8 with qwen3-moe's (2048, 768) at C = 4: a 12-bit entry (K5,
# K7), the wide study's 8/12/16-bit lanes under one tree (K6, K8) and the
# mixed-reduce bank (K8), bit for bit against the plain versions and
# against E launches, both timed
LOWRANK_EXPERT_CHECK = tuple((8, c, k, n) for c in (4, 6, 64)
                             for k, n in ((5120, 1536), (1536, 5120)))
LOWRANK_EXPERT_RAGGED = ((5, 7, 577, 65), (3, 1, 33, 9), (4, 129, 130, 1),
                         (3, 2, 100, 50))
LOWRANK_EXPERT_FULL = ((160, 4, 5120, 1536), (160, 4, 1536, 5120))
COMPOSED_EXPERT = (8, 4, 2048, 768)
# the encoder-decoder serve path: whisper-large-v3 whole (32 encoder and
# 32 decoder layers, 1 500 frames) at the serve path's settings; K9 a
# prefill: 6 a layer in the encoder, the cross-KV's 2 and 8 a layer in
# the decoder; a decode step: the decoder's 8 a layer
SERVE_ENCDEC = {**SERVE, "arch": "whisper-large-v3"}
# continuous serving of every family (``phase_serve_families``): each
# config through ``launch.serve_load.run`` under ``pallas`` (K2), one level
# of 4 Poisson requests of 2 policies (greedy and sampled alternating)
# over 4 slots; (family, arch, its arguments).  Cuts: qwen3-moe 4 of 48
# layers (~29 B parameters whole), deepseek 1 of 60 (one layer ~3.8 B),
# jamba and llava reduced (one 8-layer jamba period at width ~12 B
# parameters, ~48 GB in f32; llava's 60 layers of width 7 168 ~35 B);
# then one attention config with chunked attention, 4 keys a chunk
SERVE_FAMILIES = (
    ("ssm", "mamba2-780m", {}),
    ("encdec", "whisper-large-v3", {}),
    ("moe", "qwen3-moe-30b-a3b", {"overrides": {"n_layers": 4}}),
    ("moe+mla", "deepseek-v2-236b", {"overrides": {"n_layers": 1}}),
    ("hybrid", "jamba-v0.1-52b", {"reduced": True}),
    ("vlm", "llava-next-34b", {"reduced": True}),
    ("chunked", "qwen1.5-0.5b",
     {"overrides": {"attn_impl": "chunked", "kv_chunk": 4}}))
SERVE_FAMILY_LOAD = {"levels": [2], "n_requests": 4, "warmup": False}
# the arch also run under ``fused`` (K4), its tokens equal to pallas's
SERVE_FAMILY_FUSED = "deepseek-v2-236b"
# the static MLA serve: deepseek-v2-236b at the same depth on K9
SERVE_MLA = {**SERVE, "arch": "deepseek-v2-236b", "max_new": 4,
             "overrides": {"n_layers": 1}}
# training on the card: launch.train's run of qwen1.5-0.5b at full width
# (remat on, loss chunks of 1 024 tokens, as the config has them), and
# the reference's recorded runs of the objectives and evolve studies
LM_TRAIN = {"arch": "qwen1.5-0.5b", "steps": 10, "batch": 8, "seq": 128}
BENCH_OBJECTIVES = os.path.join(ROOT, "benchmarks", "results",
                                "BENCH_objectives.json")
BENCH_EVOLVE = os.path.join(ROOT, "benchmarks", "results",
                            "BENCH_evolve.json")
# H100 SXM FP32 FMA lanes per SM (SIMT, no tensor cores)
FP32_LANES_PER_SM = 128
# H100 SXM dense TF32 tensor-core peak (NVIDIA data sheet, 700 W); K9's
# f32-accurate 3xTF32 split takes three products per multiply-add
TF32_FLOPS_PER_S = 495e12
TF32_SPLIT_PRODUCTS = 3


# lane sharding (``phase_mesh``): the banked kernel of each variant for
# 8-bit and for mixed-width banks, the CGP ladder's cut (rungs and
# generations of the ``small`` budget's 8 and 250) and the sharded
# continuous engine's load (4 slots split 2 + 2)
MESH_KERNELS = {"pallas": ("lut_matmul_bank", "composed_matmul_bank"),
                "fused": ("fused_matmul_bank", "fused_composed_matmul_bank")}
# the ``kernels.datapaths`` call that launches each of them
MESH_CALLS = {"pallas": ("approx_matmul_lut_bank", "composed_matmul_lut_bank"),
              "fused": ("fused_matmul_lut_bank",
                        "fused_composed_matmul_lut_bank")}
MESH_LADDER = {"rungs": 4, "generations": 12}
MESH_SERVE = {"arch": "qwen1.5-0.5b", "n_requests": 4, "max_new": 16,
              "n_slots": 4}


def _smi(fields: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def _codes(shape, gen, device):
    import torch
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.int32,
                         device=device)


def _wcodes(shape, gen, device):
    """16-bit codes: every digit of a composed (12/16-bit) operand."""
    import torch
    return torch.randint(0, 1 << 16, shape, generator=gen,
                         dtype=torch.int32, device=device)


def _populations(device) -> dict:
    """One CGP generation of the ``small`` ladder per evolved family
    (8 rungs x lambda 4 = 32 mutants of the padded seed) with the search
    planes of its evaluator (8192 vectors): the population kernel K11's
    inputs on the main path."""
    import numpy as np
    from repro_torch.core.cgp import CgpParams, mutate, pad_nodes
    from repro_torch.core.evolve_pop import PopEvaluator
    from repro_torch.core.netlist import stack_netlists
    from repro_torch.core.seeds import array_multiplier, ripple_carry_adder
    from repro_torch.kernels import ops
    out = {}
    for name, exact, seed in (("mul8", array_multiplier(8), 1234),
                              ("add8", ripple_carry_adder(8), 4321)):
        ev = PopEvaluator(exact, CgpParams(metric="mae", seed=seed),
                          engine="device", device=device)
        padded = pad_nodes(exact, exact.n_nodes, seed=seed + 100)
        rng = np.random.default_rng(seed)
        pop = [mutate(padded, rng, 4) for _ in range(32)]
        out[name] = {"netlists": pop, "words": ev.planes32,
                     "tensors": ops.netlist_tensors(stack_netlists(pop),
                                                    exact.n_i, device)}
    return out


def _random_netlist(rng, n_i: int, n_o: int, n_nodes: int):
    """A random valid netlist whose first gates take every gate code."""
    import numpy as np
    from repro_torch.core.netlist import Netlist
    funcs = rng.integers(0, 10, n_nodes)
    funcs[:min(10, n_nodes)] = rng.permutation(10)[:min(10, n_nodes)]
    lim = n_i + np.arange(n_nodes)
    return Netlist(n_i=n_i, n_o=n_o, funcs=funcs.astype(np.int32),
                   in0=rng.integers(0, lim).astype(np.int32),
                   in1=rng.integers(0, lim).astype(np.int32),
                   outputs=rng.integers(0, n_i + n_nodes, n_o).astype(
                       np.int32))


def _bitsim_cases() -> list:
    """K10/K11 compare cases beyond the populations, one or more for
    each walk of ``bitsim.walk_plan``: (label, netlists, words)."""
    import numpy as np
    from repro_torch.core.cgp import mutate
    from repro_torch.core.netlist import Netlist
    from repro_torch.core.seeds import array_multiplier, ripple_carry_adder
    rng = np.random.default_rng(19)
    n = 1000
    chain = Netlist(n_i=2, n_o=2, funcs=(np.arange(n) % 8).astype(np.int32),
                    in0=(1 + np.arange(n)).astype(np.int32),
                    in1=(np.arange(n) // 2).astype(np.int32),
                    outputs=np.array([1 + n, 2 + n // 2], np.int32))
    cases = [("deep chain (1000 levels)", [chain, chain], 100),
             ("exact mul8, exhaustive", [array_multiplier(8)], 2048),
             ("1806 signals", [_random_netlist(rng, 16, 8, 1790)
                               for _ in range(2)], 70)]
    for name, seed in (("mul8", array_multiplier(8)),
                       ("add8", ripple_carry_adder(8))):
        pop = [seed] + [mutate(seed, rng, 4) for _ in range(5)]
        cases += [(f"{name} mutants, ragged", pop, w)
                  for w in (1, 33, 257, 1000)]
    return cases


def _floats(shape, gen, device, scale=1.0):
    import torch
    return torch.randn(shape, generator=gen, device=device) * scale


def int_ops_per_product(mask: int, kind: int, k: int) -> tuple:
    """(logic, arith): the integer ops a gather kernel cannot avoid per
    product, by the pipes that can issue them.  Logic ops (AND, OR; a
    LOP3 takes three inputs) issue on the ALU pipe only; adds and
    shift-adds (IADD3 takes three inputs, IMAD a power-of-two factor) on
    the ALU or the FMA pipe.  A narrow product: its table address (one
    add) and the accumulate, (0, 2).  A wide product: four addresses, the
    reduce tree of ``registry.reduce_apply`` at the lane's constant
    code, the 2W-bit mask (none when it is all ones) and the two limb
    sums (acc += p; hi += p >> 16, one LEA.HI or IMAD.HI).  The tree:
    exact (0, 3); trunc (a & h) + (b & h), one mask more when k > 16 puts
    h below p11 << 16, none when k = 0, and 0 when k >= 32; a loa node
    at 1 <= k <= 31 with c = a & b is a + b + (c & cbit) - (c & (cbit -
    1)), (2, 2), an add (0, 1) where the second operand's low k bits are
    clear (node 2 for k <= 8, node 3 for k <= 16), else (2, 3) with its
    shift; at k >= 32 a node is a | b, at k = 0 a + b + (a & b & 1)."""
    if not mask:
        return 0, 2
    if kind == 0:
        tree = (0, 3)
    elif kind == 1:
        tree = ((0, 3) if k == 0 else (0, 0) if k >= 32
                else (3 + (k > 16), 3))
    elif k >= 32:
        tree = (3, 2)
    elif k == 0:
        tree = (3, 5)
    else:
        node2 = (0, 1) if k <= 8 else (2, 3)
        node3 = (0, 1) if k <= 16 else (2, 3)
        tree = (2 + node2[0] + node3[0], 2 + node2[1] + node3[1])
    return tree[0] + (mask != 0xFFFFFFFF), 4 + tree[1] + 2


def int_seconds(logic: int, arith: int, alu_rate: float) -> float:
    """The least time for these integer ops: logic ops on the ALU pipe
    alone, all of them spread over the ALU and FMA pipes."""
    return max(logic / alu_rate, (logic + arith) / (2 * alu_rate))


def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    logs = build.build_all()
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[build] {len(logs)} kernels built in {secs:.1f} s")
    return {"build_s": secs}


def _tables(device) -> dict:
    """Every table set the compare and timing phases use: the case
    study's 17 product tables (uint16), a random table with LUT[0,0] !=
    0, the wide study's mixed-width bank and a mixed-reduce bank."""
    import numpy as np
    import torch
    from repro_torch.approx.specs import bank_for
    from repro_torch.core.library import get_default_library
    from repro_torch.launch import arch_profiles, serve_load
    from repro_torch.launch.case_study import case_study_names
    from repro_torch.launch.wide_pareto import wide_names
    lib = get_default_library()

    def u16(a):
        return torch.from_numpy(np.asarray(a).astype(np.uint16)).to(device)

    def lanes(bank):
        bits = torch.from_numpy(bank.lane_bits).to(device)
        return {"luts": u16(bank.luts), "bits": bits,
                "masks": torch.from_numpy(bank.lane_masks.astype(
                    np.int64)).to(device),
                "codes": torch.from_numpy(bank.lane_reduce_codes).to(device)}

    rand = np.random.default_rng(7).integers(0, 1 << 16, (256, 256))
    rand[0, 0] = 12345
    case = case_study_names(lib)
    wide = bank_for(case_study_names(lib, 6) + wide_names(lib), lib)
    mixed_names = [lib.add_composed(*r).name for r in MIXED_REDUCE]
    mixed = bank_for(["mul8u_bam_h0_v4"] + mixed_names, lib,
                     mixed_reduce=True)
    out = {"case": u16(np.stack([lib.lut(n) for n in case])),
           "rand": u16(rand), "wide": lanes(wide), "mixed": lanes(mixed),
           "wide_names": wide.names,
           "serve": u16(bank_for(serve_load.MULTIPLIERS, lib).luts),
           "profile": u16(bank_for(arch_profiles._multipliers(lib, True),
                                   lib).luts)}
    # the wide bank's lanes reordered: its wide lanes first, and narrow
    # and wide lanes alternating
    narrow = [i for i, m in enumerate(wide.lane_masks) if not m]
    wide_i = [i for i in range(len(wide.names)) if i not in narrow]
    alternate = [i for pair in zip(narrow, wide_i) for i in pair]
    alternate += narrow[len(wide_i):] + wide_i[len(narrow):]
    for key, order in (("wide_first", wide_i + narrow),
                       ("interleaved", alternate)):
        out[key] = {k: torch.stack([v[i] for i in order])
                    for k, v in out["wide"].items()}
    # the mixed-reduce bank's first (narrow) lane gets the random table
    out["mixed"]["luts"][0] = out["rand"]
    if out["case"].shape[0] != N_LANES:
        raise AssertionError(f"case study has {out['case'].shape[0]} "
                             f"tables, expected {N_LANES}")
    return out


def _fused_cases(t: dict, x, xb17, xbw, w):
    """(kernel, op, plain, args, bits) of every fused compare case at
    one shape: the op's operands, and the widths to calibrate them at
    (an int, or the bank's per-lane widths)."""
    from repro_torch.kernels import ops, ref
    case, rand, wide, mixed = t["case"], t["rand"], t["wide"], t["mixed"]
    bank17 = case.clone()
    bank17[-1] = rand                                   # LUT00 != 0 lane
    return [
        ("fused_matmul", ops.fused_matmul_lut, ref.fused_matmul_ref,
         (x, w, case[0]), (), 8),
        ("fused_matmul", ops.fused_matmul_lut, ref.fused_matmul_ref,
         (x, w, rand), (), 8),
        ("fused_matmul_bank", ops.fused_matmul_lut_bank,
         ref.fused_matmul_bank_ref, (x, w, bank17), (), 8),
        ("fused_matmul_bank", ops.fused_matmul_lut_bank,
         ref.fused_matmul_bank_ref, (xb17, w, bank17), (), 8),
        ("fused_composed_matmul", ops.fused_composed_matmul_lut,
         ref.fused_composed_matmul_ref, (x, w, wide["luts"][-5]),
         (wide["masks"][-5:-4], wide["codes"][-5:-4]), 16),
        ("fused_composed_matmul", ops.fused_composed_matmul_lut,
         ref.fused_composed_matmul_ref, (x, w, rand),
         (mixed["masks"][1:2], mixed["codes"][1:2]), 16),
        ("fused_composed_matmul_bank", ops.fused_composed_matmul_lut_bank,
         ref.fused_composed_matmul_bank_ref, (xbw, w, wide["luts"]),
         (wide["masks"], wide["codes"]), wide["bits"]),
        ("fused_composed_matmul_bank", ops.fused_composed_matmul_lut_bank,
         ref.fused_composed_matmul_bank_ref, (x, w, mixed["luts"]),
         (mixed["masks"], mixed["codes"]), mixed["bits"]),
    ] + [("fused_composed_matmul_bank", ops.fused_composed_matmul_lut_bank,
          ref.fused_composed_matmul_bank_ref, (xbw, w, t[key]["luts"]),
          (t[key]["masks"], t[key]["codes"]), t[key]["bits"])
         for key in ("wide_first", "interleaved")]


def _scalars(x, w, bits):
    from repro_torch.approx.quant import calibrate, scalar_params
    return scalar_params(calibrate(x, bits, lanes=x.ndim == 3),
                         calibrate(w, bits))


def phase_compare(shapes: dict, device) -> dict:
    import numpy as np
    import torch
    from repro_torch.approx.registry import encode_reduce
    from repro_torch.core.netlist import stack_netlists
    from repro_torch.kernels import bitsim as kbitsim
    from repro_torch.kernels import composed_matmul as cm
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.approx_matmul import sm_count
    from repro_torch.kernels.lowrank_matmul import plan
    gen = torch.Generator(device=device).manual_seed(0)
    t = _tables(device)
    wide = t["wide"]
    max_err = {name: 0.0 for name in SOURCES}
    cases = 0
    lowrank_cases = []

    def check(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        for g, v in zip(got, want):
            v = v.reshape(g.shape)
            if g.numel():
                err = float((g.double() - v.double()).abs().max())
                max_err[name] = max(max_err[name], err)
            if not torch.equal(g, v):
                raise AssertionError(f"{name} != plain at {what} "
                                     f"(max abs err {max_err[name]})")
        cases += 1

    bank = torch.cat([t["case"][1:], t["rand"][None]])  # LUT00 != 0 lane
    luts32 = bank.to(torch.int32)
    n_wide = t["wide"]["luts"].shape[0]
    unsplit = [s_ for s_ in SPLIT if fm.k_split(
        1, *s_, sm_count(device.index or 0)).splits == 1]
    if unsplit:
        raise AssertionError(f"split cases not split at one lane: {unsplit}")
    all_shapes = (list(shapes.items())
                  + [(f"ragged{s}", s) for s in RAGGED]
                  + [(f"split{s}", s) for s in SPLIT])

    def check_fused(cases, what, k):
        for name, op, plain, args, codes, bits in cases:
            sp = _scalars(args[0], args[1], bits)
            lanes = args[2].shape[0] if args[2].ndim == 3 else 1
            fp, ip = fm.pack_scalars(lanes, device, *sp)
            packed = fm.pack_codes(lanes, device, *codes) if codes else ()
            want = plain(args[0], args[1], args[2].to(torch.int32), *packed,
                         fp, ip)
            got = op(*args, *codes, *sp, raw=True)
            check(name, got, want, f"{what} x{tuple(args[0].shape)}")
            s = (fm.limbs_to_f32(*want[:2]) if codes
                 else want[0].to(torch.float32))
            check(name, [op(*args, *codes, *sp)],
                  [fm.dequant(s, want[-2], want[-1], fp, ip, k)],
                  f"{what} f32")

    for m, k, n in QUANT8_RAGGED:             # K3 and K4 cases only
        x = _floats((m, k), gen, device)
        w = _floats((k, n), gen, device, 0.2)
        xb17 = _floats((N_LANES, m, k), gen, device)
        check_fused(_fused_cases(t, x, xb17, None, w)[:4],
                    f"quant8 ragged {(m, k, n)}", k)
    for label, (m, k, n) in all_shapes:
        what = f"{label} {(m, k, n)}"
        qa = _codes((m, k), gen, device)
        qw = _codes((k, n), gen, device)
        for lut in (t["case"][0], t["rand"]):
            check("lut_matmul", [ops.approx_matmul_lut(qa, qw, lut)],
                  [ref.approx_matmul_lut_ref(qa, qw, lut.to(torch.int32))],
                  what)
        check("lut_matmul_bank", [ops.approx_matmul_lut_bank(qa, qw, bank)],
              [ref.approx_matmul_lut_bank_ref(qa, qw, luts32)],
              f"{what} shared qa")
        qab = _codes((N_LANES, m, k), gen, device)
        check("lut_matmul_bank", [ops.approx_matmul_lut_bank(qab, qw, bank)],
              [ref.approx_matmul_lut_bank_ref(qab, qw, luts32)],
              f"{what} banked qa")
        del qa, qw, qab
        x = _floats((m, k), gen, device)
        w = _floats((k, n), gen, device, 0.2)
        xb17 = _floats((N_LANES, m, k), gen, device)
        xbw = _floats((n_wide, m, k), gen, device)
        check_fused(_fused_cases(t, x, xb17, xbw, w), what, k)
        del x, w, xb17, xbw
        # two-step composed on codes (K5, K6): 16-bit codes; the wide
        # study's 12-lane bank with shared or per-lane codes
        qa, qw = _wcodes((m, k), gen, device), _wcodes((k, n), gen, device)
        for lut, mask, red in ((wide["luts"][-5], 0xFFFFFFFF, ("loa", 4)),
                               (t["rand"], 0xFFFFFF, ("trunc", 3)),
                               (t["rand"], 0, ("loa", 4))):
            masks1 = torch.tensor([mask], dtype=torch.int64, device=device)
            code1 = torch.tensor([encode_reduce(red)], dtype=torch.int32,
                                 device=device)
            want = ref.composed_matmul_limbs_ref(
                qa, qw, lut.to(torch.int32), masks1, code1)
            check("composed_matmul",
                  ops.composed_matmul_lut(qa, qw, lut, mask, red, raw=True),
                  want, f"{what} mask {mask:#x} {red}")
            check("composed_matmul",
                  [ops.composed_matmul_lut(qa, qw, lut, mask, red)],
                  [fm.limbs_to_f32(*want)], f"{what} f32")
        luts_r = wide["luts"].clone()
        luts_r[-1] = t["rand"]                      # LUT00 != 0 wide lane
        qab = _wcodes((n_wide, m, k), gen, device)
        qwb = _wcodes((n_wide, k, n), gen, device)
        for a_, w_, bank_ in ((qa, qw, wide), (qab, qwb, wide),
                              (qa, qw, {**wide, "luts": luts_r}),
                              (qa, qw, t["wide_first"]),
                              (qab, qwb, t["wide_first"]),
                              (qa, qw, t["interleaved"]),
                              (qab, qwb, t["interleaved"])):
            tab, masks_ = bank_["luts"], bank_["masks"]
            want = ref.composed_matmul_bank_ref(
                a_, w_, tab.to(torch.int32), masks_, bank_["codes"])
            check("composed_matmul_bank",
                  ops.composed_matmul_lut_bank(a_, w_, tab, masks_,
                                               ("loa", 4), raw=True),
                  want, f"{what} qa{tuple(a_.shape)} qw{tuple(w_.shape)}")
            check("composed_matmul_bank",
                  [ops.composed_matmul_lut_bank(a_, w_, tab, masks_,
                                                ("loa", 4))],
                  [fm.limbs_to_f32(*want)], f"{what} f32")
        # a bank mixing reduce trees, one code per lane (the kernel's own
        # interface: the op takes one tree for the bank)
        mixed = t["mixed"]
        check("composed_matmul_bank",
              cm.composed_matmul_bank(qa, qw, mixed["luts"],
                                      mixed["masks"], mixed["codes"]),
              ref.composed_matmul_bank_ref(
                  qa, qw, mixed["luts"].to(torch.int32), mixed["masks"],
                  mixed["codes"]), f"{what} mixed reduce")
        del qa, qw, qab, qwb
    # the continuous serving step: a P-lane gather of the 8-table bank,
    # per-lane codes (K2) or floats (K4), at its rows and projections
    for p_, idx in CONTINUOUS_LANES.items():
        # index_select: CUDA's advanced indexing has no uint16 kernel
        luts = t["serve"].index_select(0, torch.tensor(idx, device=device))
        for m in CONTINUOUS_ROWS:
            for k, n in CONTINUOUS_KN:
                what = f"continuous step P={p_} {(m, k, n)}"
                qab = _codes((p_, m, k), gen, device)
                qw = _codes((k, n), gen, device)
                check("lut_matmul_bank",
                      [ops.approx_matmul_lut_bank(qab, qw, luts)],
                      [ref.approx_matmul_lut_bank_ref(
                          qab, qw, luts.to(torch.int32))], what)
                del qab, qw
                xb = _floats((p_, m, k), gen, device)
                w = _floats((k, n), gen, device, 0.2)
                check_fused([("fused_matmul_bank", ops.fused_matmul_lut_bank,
                              ref.fused_matmul_bank_ref, (xb, w, luts), (),
                              8)], what, k)
                del xb, w
    # the module-profile sweeps: P lanes gathered from the profile's
    # 3-table bank (K2 on codes, K4 on floats), and the sequential
    # evaluations' single tables (K1, K3), at the full-width shapes
    for p_, m, k, n in PROFILE_STEP + PROFILE_STEP_CHECK:
        what = f"profile sweep P={p_} {(m, k, n)}"
        idx = torch.arange(p_, device=device) % t["profile"].shape[0]
        luts = t["profile"].index_select(0, idx)
        qa = _codes((m, k), gen, device)
        qab = _codes((p_, m, k), gen, device)
        qw = _codes((k, n), gen, device)
        check("lut_matmul", [ops.approx_matmul_lut(qa, qw, luts[-1])],
              [ref.approx_matmul_lut_ref(qa, qw, luts[-1].to(torch.int32))],
              what)
        for a_ in (qa, qab):
            check("lut_matmul_bank",
                  [ops.approx_matmul_lut_bank(a_, qw, luts)],
                  [ref.approx_matmul_lut_bank_ref(
                      a_, qw, luts.to(torch.int32))], what)
        del qa, qab, qw
        x = _floats((m, k), gen, device)
        xb = _floats((p_, m, k), gen, device)
        w = _floats((k, n), gen, device, 0.2)
        check_fused([("fused_matmul", ops.fused_matmul_lut,
                      ref.fused_matmul_ref, (x, w, luts[-1]), (), 8),
                     ("fused_matmul_bank", ops.fused_matmul_lut_bank,
                      ref.fused_matmul_bank_ref, (xb, w, luts), (), 8),
                     ("fused_matmul_bank", ops.fused_matmul_lut_bank,
                      ref.fused_matmul_bank_ref, (x, w, luts), (), 8)],
                    what, k)
        del x, xb, w
    mult, factors = _served_factors(device)
    for label, (m, k, n) in list(LOWRANK_SHAPES.items()) + [
            (f"ragged{s_}", s_) for s_ in LOWRANK_RAGGED]:
        qa = _codes((m, k), gen, device)
        qw = _codes((k, n), gen, device)
        for rname, (u, v) in factors.items():
            got = ops.lowrank_matmul(qa, qw, u, v)
            err, ratio, worst = _check_lowrank(
                got, ref.lowrank_matmul_ref(qa, qw, u, v), qa, qw, u, v,
                f"{label} {(m, k, n)} {mult} {rname}")
            max_err["lowrank_matmul"] = max(max_err["lowrank_matmul"], err)
            lowrank_cases.append({
                "case": label, "M": m, "K": k, "N": n, "rank": rname,
                "regime": plan(m, k, n, u.shape[0]).regime,
                "max_abs_err": err, "err_over_bound": ratio, **worst})
            # the split-K partials are summed in a fixed order: a second
            # call gives the same bits
            check("lowrank_matmul", [ops.lowrank_matmul(qa, qw, u, v)],
                  [got], f"{label} {(m, k, n)} {rname} repeated")
    for name, pop in _populations(device).items():
        check("bitsim_pop", [ops.bitsim_pop_planes(*pop["tensors"],
                                                   pop["words"])],
              [ref.bitsim_pop_ref(*pop["tensors"], pop["words"])],
              f"{name} generation (32 x {pop['words'].shape[1]} words)")
    # every walk of K10/K11 (bitsim.walk_plan): a deep chain and the
    # exact multiplier (level), a netlist past the staged descriptors
    # (serial_global), ragged word counts (both walks)
    for what, nls, w in _bitsim_cases():
        n_i = nls[0].n_i
        words = ops.words_to_device(np.random.default_rng(w).integers(
            0, 2 ** 32, (n_i, w), dtype=np.uint64).astype(np.uint32),
            device)
        tens = ops.netlist_tensors(stack_netlists(nls), n_i, device)
        walks = {kbitsim.walk_plan(n_i, tens[0].shape[1], len(nls), w,
                                   sm_count(device.index or 0)).walk,
                 kbitsim.walk_plan(n_i, nls[0].n_nodes, 1, w,
                                   sm_count(device.index or 0)).walk}
        check("bitsim_pop", [ops.bitsim_pop_planes(*tens, words)],
              [ref.bitsim_pop_ref(*tens, words)],
              f"{what} x{len(nls)}, {w} words ({sorted(walks)})")
        one = ops.netlist_tensors((nls[0].funcs, nls[0].in0, nls[0].in1,
                                   nls[0].outputs), n_i, device)
        check("bitsim", [ops.bitsim_planes(*one, words)],
              [ref.bitsim_ref(*one, words)], f"{what}, {w} words")
    lowrank_ratio = max(c["err_over_bound"] for c in lowrank_cases)
    print(f"[compare] {cases} kernel-vs-plain cases: bit-exact, K9 within "
          f"its bound (max |K9 - y64| / bound {lowrank_ratio:.3g}); max abs "
          f"err {max_err}")
    print("[compare] K9 per case: " + json.dumps(lowrank_cases))
    return {"cases": cases, "max_abs_err": max_err,
            "lowrank_err_over_bound": lowrank_ratio,
            "lowrank_cases": lowrank_cases}


def _served_factors(device):
    """The served multiplier (``pick_case_multiplier``) and its factor
    tables on the card at rank 4 and at its auto rank."""
    from repro_torch.approx.specs import BackendSpec
    from repro_torch.launch.steps import pick_case_multiplier
    name = pick_case_multiplier()
    out = {}
    for rank in (4, None):
        c = BackendSpec(mode="lowrank", multiplier=name,
                        rank=rank).materialize().device_consts(device)
        tag = f"R={c['u'].shape[0]}" + (" (auto)" if rank is None else "")
        out[tag] = (c["u"], c["v"])
    return name, out


def _check_lowrank(got, plain, qa, qw, u, v, what: str) -> tuple:
    """K9 and its plain version against the bound both are held to
    (``kernels.ref.lowrank_bound``, per slice of the expert form: qa
    (X,M,K), qw (E,K,N)): |y - y64| <= 2 (K R + 1) 2^-24 S elementwise,
    y64 the sum in float64, S = Σ_r |U_r(qa)| @ |V_r(qw)|.  Returns max
    |kernel - plain|, the kernel's max |y - y64| / tol and that element's
    y64, S, |y - y64| and tol."""
    import torch
    from repro_torch.kernels import ref
    torch.cuda.synchronize()
    y64, tol = (ref.lowrank_bound_experts if qw.ndim == 3
                else ref.lowrank_bound)(qa, qw, u, v)
    for name, y in (("kernel", got), ("plain", plain)):
        if not (y.shape == y64.shape and bool(torch.isfinite(y).all())
                and bool(((y.double() - y64).abs() <= tol).all())):
            raise AssertionError(f"lowrank_matmul {name} outside its bound "
                                 f"at {what}")
    if not got.numel():
        return 0.0, 0.0, {}
    diff = (got.double() - y64).abs()
    ratios = diff / tol.clamp_min(1e-300)
    i = int(ratios.argmax())
    k, r = qa.shape[-1], u.shape[0]
    worst = {"y64": float(y64.flatten()[i]),
             "S": float(tol.flatten()[i]) / (2.0 * (k * r + 1) * 2.0 ** -24),
             "abs_err": float(diff.flatten()[i]),
             "tol": float(tol.flatten()[i])}
    return float((got - plain).abs().max()), float(ratios.flatten()[i]), worst


def phase_compare_library(lib, device, max_err: dict) -> dict:
    """K10 against ``Netlist.eval_words`` and its plain version on
    exhaustive planes (65 536 vectors) for every evolved netlist of the
    library built on the main path."""
    import torch
    from repro_torch.core.netlist import exhaustive_inputs
    from repro_torch.kernels import ops, ref
    evolved = [e for e in lib.entries.values() if e.source == "evolved"]
    if not evolved:
        raise AssertionError("the built library has no evolved entry")
    planes = {}
    for e in evolved:
        nl = e.netlist
        if nl.n_i not in planes:
            p64 = exhaustive_inputs(nl.n_i)
            planes[nl.n_i] = (p64, ops.words_to_device(
                ops.split_planes64(p64), device))
        p64, words = planes[nl.n_i]
        tens = ops.netlist_tensors((nl.funcs, nl.in0, nl.in1, nl.outputs),
                                   nl.n_i, device)
        got = ops.bitsim_planes(*tens, words)
        plain = ref.bitsim_ref(*tens, words)
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            max_err["bitsim"] = max(max_err["bitsim"], float(
                (got.double() - plain.double()).abs().max()))
            raise AssertionError(f"bitsim != plain on {e.name}")
        if not (ops.join_planes32(ops.words_to_host(got))
                == nl.eval_words(p64)).all():
            raise AssertionError(f"bitsim != eval_words on {e.name}")
    print(f"[compare] K10 equals eval_words and its plain version on "
          f"{len(evolved)} evolved netlists, exhaustive planes")
    return {"netlists": len(evolved)}


def _drive(name: str, fn, kernels: tuple):
    """Run one main path with the launch counters zeroed just before it;
    fails unless each of ``kernels`` launched."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    record = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"[main] {name}: {wall:.2f} s; launches {launches}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{name}: kernels of its path never ran: "
                             f"{missing}")
    return record, wall, launches


def _case_accuracies(record) -> dict:
    res = record["result"]
    return {"all_layers": [p["accuracy"] for p in res["all_layers"]],
            "per_layer": [p["accuracy"] for p in res["per_layer"]],
            "baseline": res["baseline_accuracy"],
            "selected": record["selected"]}


def _check_banked_logits(record, variant, device):
    """The CUDA datapath against the plain datapath through the whole
    network, on one eval batch: banked logits equal bit for bit."""
    import torch
    from repro_torch.approx.layers import ApproxPolicy, bank_backend
    from repro_torch.approx.specs import bank_for
    from repro_torch.core.library import get_default_library
    from repro_torch.data.synthetic import CifarBatches
    from repro_torch.models import resnet
    from repro_torch.models.weights import load_resnet8
    bank = bank_for(record["multipliers"], get_default_library())
    b = next(CifarBatches("test", BATCH, BATCH).eval_batches())
    images = torch.from_numpy(b["images"]).to(device)
    model = load_resnet8().to(device)
    cfg = resnet.resnet_config(8)
    with torch.inference_mode():
        got = resnet.forward(model, images, cfg, ApproxPolicy(
            default=bank_backend(bank, "lut", variant)))
        want = resnet.forward(model, images, cfg, ApproxPolicy(
            default=bank_backend(bank, "lut", "ref")))
    if not (torch.isfinite(got).all() and torch.equal(got, want)
            and got.shape == (N_LANES, BATCH, cfg.n_classes)):
        raise AssertionError(f"{variant} datapath logits differ from the "
                             "plain datapath's")
    print(f"[main] {variant} banked logits (17 lanes x 64 images) equal "
          "the plain datapath's")


def phase_main(device) -> dict:
    from repro_torch.launch import case_study, wide_pareto

    def log(s):
        print(f"[main] {s}")

    out = {"launches": {name: 0 for name in SOURCES}}
    accs = {}
    for variant, kernels in (("pallas", ("lut_matmul", "lut_matmul_bank")),
                             ("fused", ("fused_matmul",
                                        "fused_matmul_bank"))):
        record, wall, launches = _drive(
            f"case study ({variant})",
            lambda: case_study.run(device, eval_n=EVAL_N, batch=BATCH,
                                   log=log, variant=variant), kernels)
        res = record["result"]
        accs[variant] = _case_accuracies(record)
        if (len(res["all_layers"]) != N_LANES
                or len(res["per_layer"]) != 9 * N_LANES
                or not all(0.0 <= a <= 1.0
                           for a in accs[variant]["all_layers"]
                           + accs[variant]["per_layer"])
                or record["selected"] is None):
            raise AssertionError(f"{variant} case study output malformed")
        _check_banked_logits(record, variant, device)
        out[f"case_study_{variant}"] = {**record, "main_path_s": wall,
                                        "launches": launches}
        for k, v in launches.items():
            out["launches"][k] += v
    if accs["fused"] != accs["pallas"]:
        raise AssertionError(f"fused case study differs from the pallas "
                             f"one: {accs}")
    print("[main] fused case study accuracies equal the pallas ones, "
          "list for list")
    wide_rows = {}
    for variant, kernels in (("fused", ("fused_matmul",
                                        "fused_composed_matmul",
                                        "fused_composed_matmul_bank")),
                             ("pallas", ("lut_matmul", "composed_matmul",
                                         "composed_matmul_bank"))):
        record, wall, launches = _drive(
            f"wide-width Pareto study ({variant})",
            lambda: wide_pareto.run(device, eval_n=EVAL_N, batch=BATCH,
                                    log=log, variant=variant), kernels)
        if len(record["sweep"]) != 12 or record["variant"] != variant:
            raise AssertionError(f"wide study ({variant}) output malformed")
        wide_rows[variant] = record["sweep"]
        key = "wide_pareto" if variant == "fused" else "wide_pareto_pallas"
        out[key] = {**record, "main_path_s": wall, "launches": launches}
        for k, v in launches.items():
            out["launches"][k] += v
    if wide_rows["pallas"] != wide_rows["fused"]:
        raise AssertionError(f"wide study rows differ between variants: "
                             f"{wide_rows}")
    print("[main] wide study rows (accuracy, logit_mae) under pallas equal "
          "the fused ones, point for point")
    out.update(phase_heterogeneous(device, log, out["launches"]))
    out.update(phase_dse_surrogate(device, log, out["launches"]))
    lib, record = phase_library(device, log, out["launches"])
    out["library"] = record
    out["serve"] = phase_serve(device, log, out["launches"])
    if min(out["launches"].values()) <= 0:
        raise AssertionError(f"a kernel never ran on the main paths: "
                             f"{out['launches']}")
    return out, lib


def _hetero_decisions(record) -> dict:
    return {k: record[k] for k in ("baseline_accuracy", "uniform",
                                   "uniform_best", "heterogeneous",
                                   "selected", "dominating")}


def _study(device, log, variant: str, **kw) -> dict:
    """``heterogeneous_pareto.run``; its equal-assignment and verification
    gates raise here, while a failed dominance gate is the study's
    result at this size: printed, kept in the record
    (``dominating: null``), and not a fault of the port."""
    from repro_torch.launch import heterogeneous_pareto
    try:
        return heterogeneous_pareto.run(device, log=log, variant=variant,
                                        **kw)
    except heterogeneous_pareto.GateError as e:
        if e.gate != "dominance":
            raise
        r = e.record
        log(f"DOMINANCE GATE FAILED ({variant}, {r['eval_n']} images): no "
            f"verified heterogeneous point dominates the best uniform "
            f"point {r['uniform_best']} within {r['quality_bound']}")
        return r


def _check_study(record, kernels: tuple, label: str) -> None:
    """The correctness gates held, and the batched verification launched
    the banked kernel exactly once a layer and eval batch and nothing
    else (no silent sequential path)."""
    v = record["verification"]
    want = {kernels[1]: v["layers"] * record["eval_batches"]}
    if (v["batched_launches"] != want or v["k"] < 2
            or not (record["equal_assignment_bit_identical"]
                    and v["bit_identical"])):
        raise AssertionError(
            f"heterogeneous study ({label}) malformed: batched "
            f"verification launched {v['batched_launches']} (want "
            f"{want}), k {v['k']}")
    print(f"[main] heterogeneous ({label}) on {_smi('name,power.limit')}: "
          f"explore_heterogeneous (per-layer sweep, beam, batched "
          f"verification) {record['explore_heterogeneous_s']:.3f} s; "
          f"verification of {v['k']} assignments batched "
          f"{v['batched_s']:.3f} s ({want}), sequential "
          f"{v['sequential_s']:.3f} s, speedup {v['speedup']:.2f}; "
          f"equal-assignment check {record['equal_assignment_s']:.3f} s; "
          f"dominating {record['dominating'] is not None}")


def _check_against_bench(record) -> None:
    """The ``--quick`` study against the reference's recorded run of the
    same configuration (``BENCH_HETEROGENEOUS``, read as JSON): the same
    multipliers; the same uniform points, verified assignments, best
    uniform point, selection and dominating point, each with its power
    (the reference rounds to six places); every accuracy within one
    image."""
    with open(BENCH_HETEROGENEOUS) as f:
        want = json.load(f)
    tol = 1 / record["eval_n"]
    bad = []

    def same(got, ref, what):
        if (got is None) != (ref is None):
            bad.append(f"{what}: {got} != {ref}")
            return
        if got is None:
            return
        if (got["multiplier"] != ref["multiplier"]
                or got.get("assignment") != ref.get("assignment")
                or round(got["network_rel_power"], 6)
                != ref["network_rel_power"]
                or abs(got["accuracy"] - ref["accuracy"]) > tol):
            bad.append(f"{what}: {got} != {ref}")

    def by_point(points):
        return sorted(points, key=lambda p: (
            round(p["network_rel_power"], 6),
            json.dumps(p.get("assignment") or p["multiplier"],
                       sort_keys=True)))

    if record["multipliers"] != want["multipliers"]:
        bad.append(f"multipliers {record['multipliers']} != "
                   f"{want['multipliers']}")
    if abs(record["baseline_accuracy"] - want["baseline_accuracy"]) > tol:
        bad.append(f"baseline {record['baseline_accuracy']} != "
                   f"{want['baseline_accuracy']}")
    for key in ("uniform", "heterogeneous"):
        got, ref = by_point(record[key]), by_point(want[key])
        if len(got) != len(ref):
            bad.append(f"{key}: {len(got)} points != {len(ref)}")
        for i, (g, r) in enumerate(zip(got, ref)):
            same(g, r, f"{key}[{i}]")
    for key in ("uniform_best", "selected", "dominating"):
        same(record[key], want[key], key)
    if bad:
        raise AssertionError("heterogeneous --quick study differs from "
                             "the reference's recorded run: "
                             + "; ".join(bad))
    print(f"[main] heterogeneous (pallas --quick) equals the reference's "
          f"recorded run ({os.path.relpath(BENCH_HETEROGENEOUS, ROOT)}): "
          f"{len(want['multipliers'])} multipliers, "
          f"{len(want['heterogeneous'])} verified assignments, selection "
          f"{want['selected']['multiplier']}, dominating point, powers "
          f"equal, accuracies within {tol}")


def phase_heterogeneous(device, log, launches_total: dict) -> dict:
    """Path: the heterogeneous per-layer DSE under each variant through
    ``heterogeneous_pareto.run`` at the reference's default size (256
    images, 8 picks + extras), its correctness gates and launches
    (``_check_study``), the fused decisions equal to the pallas ones;
    then the reference's recorded ``--quick`` configuration (64 images,
    12 picks + extras) under ``pallas``, where all three gates must hold
    and the decisions must equal the reference's recorded ones
    (``_check_against_bench``); then two policy banks' logits against
    the plain datapath's (``_check_policy_bank_logits``)."""
    from repro_torch.launch import heterogeneous_pareto
    out, decisions = {}, {}
    runs = [(variant, kernels, {})
            for variant, kernels in HETERO_KERNELS.items()]
    runs.append(("pallas", HETERO_KERNELS["pallas"], dict(quick=True)))
    for variant, kernels, kw in runs:
        label = variant + (" --quick" if kw.get("quick") else "")
        if kw.get("quick"):
            study = lambda: heterogeneous_pareto.run(  # noqa: E731
                device, log=log, variant=variant, **kw)
        else:
            study = lambda: _study(device, log, variant, **kw)  # noqa: E731
        record, wall, launches = _drive(
            f"heterogeneous Pareto study ({label})", study, kernels)
        _check_study(record, kernels, label)
        if kw.get("quick"):
            _check_against_bench(record)
        else:
            decisions[variant] = _hetero_decisions(record)
        out[f"heterogeneous_{label.replace(' --', '_')}"] = {
            **record, "main_path_s": wall, "launches": launches}
        for k, n in launches.items():
            launches_total[k] += n
    if decisions["fused"] != decisions["pallas"]:
        raise AssertionError(f"heterogeneous study differs between "
                             f"variants: {decisions}")
    print("[main] heterogeneous study under fused equals pallas: uniform "
          "rows, verified points and selection, point for point")
    study = out["heterogeneous_pallas"]
    out["heterogeneous_policy_bank"] = _check_policy_bank_logits(
        device, list(POLICY_BANK_NARROW), 4, POLICY_BANK_KERNEL,
        "mixed-width", wide=True)
    out["heterogeneous_policy_bank_8bit"] = _check_policy_bank_logits(
        device, study["multipliers"], study["verification"]["k"],
        {v: k[1] for v, k in HETERO_KERNELS.items()}, "8-bit")
    return out


def _check_policy_bank_logits(device, names: list, n_rows: int,
                              kernel: dict, label: str,
                              wide: bool = False) -> dict:
    """A policy bank of ``n_rows`` assignments of ``names`` (with the
    wide study's composed 12/16-bit recipes when ``wide``) over the
    ResNet-8 layers (row ``p``'s layer ``j`` on ``names[p + j]``, the
    first layer on one table in every lane; rows repeat past
    ``len(names)``), through the whole
    network on one eval batch: logits under ``pallas`` and ``fused``
    equal the plain datapath's bit for bit, each variant's kernel
    (``kernel``) launched once a layer and nothing else."""
    import torch
    from repro_torch.approx.layers import policy_bank_eval
    from repro_torch.approx.specs import PolicyBank
    from repro_torch.core.library import get_default_library
    from repro_torch.data.synthetic import CifarBatches
    from repro_torch.kernels.ops import launches_during
    from repro_torch.launch.wide_pareto import wide_names
    from repro_torch.models import resnet
    from repro_torch.models.weights import load_resnet8
    lib = get_default_library()
    cfg = resnet.resnet_config(8)
    names = list(names) + (wide_names(lib) if wide else [])
    layers = tuple(resnet.layer_mult_counts(cfg))
    rows = [{l: names[(p + j) % len(names)] if j else names[2]
             for j, l in enumerate(layers)} for p in range(n_rows)]
    pbank = PolicyBank.from_assignments(rows, lib, layers=layers)
    b = next(CifarBatches("test", BATCH, BATCH).eval_batches())
    images = torch.from_numpy(b["images"]).to(device)
    model = load_resnet8().to(device)

    def logits(variant):
        return policy_bank_eval(
            lambda pol: {"logits": resnet.forward(model, images, cfg, pol)},
            pbank, variant=variant)["logits"]

    want = logits("ref")
    widths = sorted({lib.entry(n).width for n in pbank.bank.names})
    for variant, k in kernel.items():
        got, launches = launches_during(lambda: logits(variant))
        if not (torch.isfinite(got).all() and torch.equal(got, want)
                and got.shape == (len(rows), BATCH, cfg.n_classes)
                and launches == {k: len(layers)}):
            raise AssertionError(
                f"{label} policy-bank logits under {variant} differ from "
                f"the plain datapath's, or launches {launches} != one {k} "
                f"a layer")
    distinct = len({json.dumps(r, sort_keys=True) for r in rows})
    print(f"[main] {label} policy bank ({len(rows)} assignments, "
          f"{distinct} distinct, over {len(layers)} layers, widths "
          f"{widths}): logits under pallas ({kernel['pallas']}) and fused "
          f"({kernel['fused']}) equal the plain datapath's, one launch a "
          f"layer")
    return {"assignments": rows, "widths": widths, "distinct": distinct}


def _dse_study(device, log, variant: str, quick: bool) -> dict:
    """``dse_surrogate.run``; its fidelity gate raises here, while a
    missed speedup or front gate (``DSE_RECORDED_GATES``) is printed and
    kept in the record, where ``_check_dse`` reads every gate."""
    from repro_torch.launch import dse_surrogate
    try:
        return dse_surrogate.run(device, quick=quick, variant=variant,
                                 log=log)
    except dse_surrogate.GateError as e:
        if e.gate not in DSE_RECORDED_GATES:
            raise
        return e.record


def _front_misses(record) -> list:
    """Each missed exact-front point with the surrogate-front point of
    the lowest ``logit_mae`` at no higher power (None when there is
    none), and the gap in ``logit_mae``."""
    out = []
    for miss in record["front"]["misses"]:
        near = [p for p in record["front"]["surrogate"]
                if p["network_rel_power"]
                <= round(miss["network_rel_power"], 6)]
        best = min(near, key=lambda p: p["logit_mae"], default=None)
        out.append({**miss, "nearest": best,
                    "gap": (None if best is None
                            else best["logit_mae"] - miss["logit_mae"])})
    return out


def _check_dse(record, label: str, quick: bool) -> None:
    """Every gate read from the record: the fidelity gate must hold; a
    missed speedup gate is printed with the walls by stage; a missed
    front gate is printed and, at ``--quick``, must be a near tie (each
    missed exact-front point has a surrogate-front point at no higher
    power within ``LOGIT_MAE_ATOL``).  Each path measured 27 x 9 and
    108 x 9 (layer, circuit) cells, the MLP fit captured as a CUDA graph
    equals the eager fit bit for bit, and each path launched only the
    banked kernel, exactly once a layer and eval batch in its per-layer
    sweep and once in its verification: 2 x 9 x eval batches."""
    from repro_torch.launch import dse_surrogate
    e2e, fid, fit = record["end_to_end"], record["fidelity"], record["fit"]
    n = record["n_layers"] * record["eval_batches"]
    want = {DSE_KERNEL[record["variant"]]: 2 * n}
    bad = []
    if not fid["mean_rho"] >= dse_surrogate.FIDELITY_GATE:
        bad.append(f"fidelity gate: mean rho {fid['mean_rho']}")
    if (e2e["evals_surrogate"], e2e["evals_exact"]) != DSE_EVALS:
        bad.append(f"evaluations {e2e['evals_surrogate']} / "
                   f"{e2e['evals_exact']} != {DSE_EVALS}")
    for path, launches in record["launches"].items():
        if launches != want:
            bad.append(f"{path} path launched {launches}, want {want}")
    if not fit["bit_equal"]:
        bad.append(f"captured fit differs from the eager fit by "
                   f"{fit['max_abs_diff']}")
    misses = _front_misses(record)
    record["front_gate_missed"] = bool(misses)
    record["speedup_gate_missed"] = e2e["speedup"] < e2e["gate"]
    if quick and any(m["gap"] is None or m["gap"] > LOGIT_MAE_ATOL
                     for m in misses):
        bad.append(f"front gate missed by more than {LOGIT_MAE_ATOL}: "
                   f"{misses}")
    if bad:
        raise AssertionError(f"surrogate-guided DSE ({label}): "
                             + "; ".join(bad))
    if record["speedup_gate_missed"]:
        print(f"[main] SPEEDUP GATE MISSED ({label}): {e2e['speedup']:.2f}x "
              f"< {e2e['gate']}x")
    for m in misses:
        print(f"[main] FRONT GATE MISSED ({label}): exact-front point "
              f"logit_mae {m['logit_mae']:.6f} at power "
              f"{m['network_rel_power']:.6f}; nearest surrogate-front "
              f"point at no higher power: "
              f"{'none' if m['nearest'] is None else m['nearest']}")
    print(f"[main] surrogate-guided DSE ({label}) on "
          f"{_smi('name,power.limit')}: surrogate path "
          f"{e2e['surrogate_s']:.3f} s {e2e['surrogate_stages']}; exact "
          f"path {e2e['exact_s']:.3f} s {e2e['exact_stages']}; speedup "
          f"{e2e['speedup']:.2f}x (gate {e2e['gate']}x); MLP fit eager "
          f"{fit['eager_s']:.4f} s, captured {fit['captured_s']:.4f} s, bit "
          f"equal; fidelity mean rho {fid['mean_rho']:.4f} (min "
          f"{fid['min_rho']:.4f}) on {fid['n_unseen']} unseen; front "
          f"{'missed' if misses else 'matches or dominates'}; launches "
          f"{want} a path; peak memory "
          f"{record['max_memory_allocated'] / 2**30:.2f} GiB")


def _dse_decisions(record) -> dict:
    return {k: record["front"][k] for k in (
        "surrogate", "exact", "selected_surrogate", "selected_exact")}


def _check_against_dse_bench(record) -> None:
    """The ``--quick`` study against the reference's recorded run of the
    same configuration (``BENCH_DSE``, read as JSON): the candidate and
    layer counts, the surrogate's training and validation circuits, the
    evaluation counts and both selections equal; every ``logit_mae`` of
    a front point whose assignment the record's fronts also hold within
    ``LOGIT_MAE_ATOL``.  The exact front is printed beside the record's
    and kept (``exact_front_as_recorded``), not held: the reference's
    own run of this configuration no longer reproduces it either (its
    beam sits on the quality bound, where last-bit differences in the
    per-layer rows move it; PERF.md §6)."""
    with open(BENCH_DSE) as f:
        want = json.load(f)
    bad = []
    for key in ("n_circuits", "n_layers", "eval_n"):
        if record[key] != want[key]:
            bad.append(f"{key} {record[key]} != {want[key]}")
    for key in ("train_names", "val_names"):
        if record["surrogate"][key] != want["surrogate"][key]:
            bad.append(f"{key} {record['surrogate'][key]} != "
                       f"{want['surrogate'][key]}")
    for key in ("evals_surrogate", "evals_exact"):
        if record["end_to_end"][key] != want["end_to_end"][key]:
            bad.append(f"{key} {record['end_to_end'][key]} != "
                       f"{want['end_to_end'][key]}")
    for key in ("selected_surrogate", "selected_exact"):
        if record["front"][key] != want["front"][key]:
            bad.append(f"{key} {record['front'][key]} != "
                       f"{want['front'][key]}")

    def key_of(p):
        return json.dumps(p["assignment"], sort_keys=True)

    recorded = {key_of(p): p for side in ("surrogate", "exact")
                for p in want["front"][side]}
    pairs = [(p, recorded[key_of(p)]) for side in ("surrogate", "exact")
             for p in record["front"][side] if key_of(p) in recorded]
    for g, r in pairs:
        if abs(g["logit_mae"] - r["logit_mae"]) > LOGIT_MAE_ATOL:
            bad.append(f"logit_mae {g['logit_mae']} != {r['logit_mae']} "
                       f"at {g['assignment']}")
    if bad:
        raise AssertionError("surrogate-guided DSE (pallas --quick) "
                             "differs from the reference's recorded run: "
                             + "; ".join(bad))
    got, ref = record["front"]["exact"], want["front"]["exact"]
    same = ([(key_of(p), p["network_rel_power"]) for p in got]
            == [(key_of(p), p["network_rel_power"]) for p in ref])
    record["exact_front_as_recorded"] = same
    print(f"[main] surrogate-guided DSE (pallas --quick) against the "
          f"reference's recorded run ({os.path.relpath(BENCH_DSE, ROOT)}): "
          f"{want['n_circuits']} circuits, training and validation "
          f"circuits, {want['end_to_end']['evals_surrogate']} / "
          f"{want['end_to_end']['evals_exact']} evaluations and selections "
          f"{want['front']['selected_surrogate']} / "
          f"{want['front']['selected_exact']} equal; {len(pairs)} front "
          f"points the record also has, logit_mae within {LOGIT_MAE_ATOL}; "
          f"exact front {'as recorded' if same else 'NOT AS RECORDED'}: "
          f"{[(p['logit_mae'], p['network_rel_power']) for p in got]} "
          f"against {[(p['logit_mae'], p['network_rel_power']) for p in ref]}")


def _check_layer_pass(device) -> dict:
    """One per-layer pass of the sweep over the 108 candidates at
    ``DSE_LAYER`` and one eval batch: logits under ``pallas`` (K2) and
    ``fused`` (K4) equal the plain datapath's bit for bit, one launch
    each; the peak memory of the pallas pass is recorded."""
    import torch
    from repro_torch.core.library import load_default_library
    from repro_torch.launch import dse_surrogate
    lib = load_default_library()
    names = dse_surrogate.widen_candidate_set(lib, DSE_CIRCUITS)
    want, _ = dse_surrogate.layer_pass(lib, names, DSE_LAYER, "ref", device)
    out = {}
    for variant, kernel in DSE_KERNEL.items():
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        got, launches = dse_surrogate.layer_pass(lib, names, DSE_LAYER,
                                                 variant, device)
        torch.cuda.synchronize(device)
        out[f"{variant}_max_memory_allocated"] = \
            torch.cuda.max_memory_allocated(device)
        if not (torch.isfinite(got).all() and torch.equal(got, want)
                and got.shape == (len(names), 32, 10)
                and launches == {kernel: 1}):
            raise AssertionError(
                f"108-lane per-layer pass under {variant} differs from the "
                f"plain datapath's, or launches {launches} != one {kernel}")
    print(f"[main] 108-lane per-layer pass at {DSE_LAYER} (32 images): "
          f"logits under pallas (lut_matmul_bank) and fused "
          f"(fused_matmul_bank) equal the plain datapath's, one launch "
          f"each; peak memory pallas "
          f"{out['pallas_max_memory_allocated'] / 2**30:.2f} GiB, fused "
          f"{out['fused_max_memory_allocated'] / 2**30:.2f} GiB")
    return out


def phase_dse_surrogate(device, log, launches_total: dict) -> dict:
    """Path: the surrogate-guided DSE against the exact-sweep DSE
    through ``dse_surrogate.run``: its reference's recorded ``--quick``
    configuration under ``pallas``, checked against the record
    (``_check_against_dse_bench``), then under ``fused``, whose fronts
    and selections must equal the pallas ones, then the default size
    (64 images) under ``pallas``; each must hold the fidelity gate, its
    evaluation counts and launches (``_check_dse``); the
    process-wide default library must keep its entries; then the
    108-lane per-layer pass against the plain datapath
    (``_check_layer_pass``)."""
    from repro_torch.core.library import get_default_library
    default = get_default_library()
    before = list(default.entries)
    out, decisions = {}, {}
    for variant, quick in (("pallas", True), ("fused", True),
                           ("pallas", False)):
        label = variant + (" --quick" if quick else "")
        record, wall, launches = _drive(
            f"surrogate-guided DSE ({label})",
            lambda: _dse_study(device, log, variant, quick),
            (DSE_KERNEL[variant],))
        _check_dse(record, label, quick)
        if quick:
            decisions[variant] = _dse_decisions(record)
        if (variant, quick) == ("pallas", True):
            _check_against_dse_bench(record)
        out[f"dse_surrogate_{label.replace(' --', '_')}"] = {
            **record, "main_path_s": wall, "launches": launches}
        for k, n in launches.items():
            launches_total[k] += n
    if decisions["fused"] != decisions["pallas"]:
        raise AssertionError(f"surrogate-guided DSE differs between "
                             f"variants: {decisions}")
    print("[main] surrogate-guided DSE under fused equals pallas: exact "
          "and surrogate fronts and selections, point for point")
    if get_default_library() is not default or list(default.entries) != before:
        raise AssertionError("the surrogate-guided DSE changed the "
                             "process-wide default library")
    out["dse_surrogate_layer_pass"] = _check_layer_pass(device)
    return out


def _same_library(a, b) -> bool:
    return (list(a.entries) == list(b.entries)
            and all(a.entries[n].as_dict() == b.entries[n].as_dict()
                    for n in a.entries))


def phase_library(device, log, launches_total: dict):
    """Path A: the circuit library evolved on the card through its CLI's
    ``run`` (K11 every generation, K10 for each search's exhaustive
    re-verification), then the ``tiny`` build on the card and on the
    host, which must be equal entry for entry."""
    import math
    from repro_torch.core import build_library
    out_path = os.path.join(OUT_DIR, f"library_{LIBRARY_BUDGET}_device.json")
    os.makedirs(OUT_DIR, exist_ok=True)
    (lib, record), wall, launches = _drive(
        f"circuit library ({LIBRARY_BUDGET}, engine=device)",
        lambda: build_library.run(LIBRARY_BUDGET, "device", device,
                                  out_path, log=log),
        ("bitsim_pop", "bitsim"))
    for k, v in launches.items():
        launches_total[k] += v
    evo = record["evolution"]
    composed = record["sources"].get("composed", 0)
    if (record["sources"].get("evolved", 0) <= 0 or composed <= 0
            or set(evo) != {"mul8u", "add8u"}
            or not all(math.isfinite(x) for e in lib.entries.values()
                       for x in e.errors.as_dict().values()
                       if isinstance(x, float))):
        raise AssertionError(f"library build output malformed: {record}")
    split = {}
    for fam, st in evo.items():
        gen_s = st["evolve_s"] / st["generations"]
        dev_s = st["score_device_s"] / st["evaluator_calls"]
        split[fam] = {"generation_ms": gen_s * 1e3,
                      "device_ms": dev_s * 1e3,
                      "host_ms": (gen_s - dev_s) * 1e3}
        log(f"{fam}: {st['generations']} generations of "
            f"{st['rungs']} x {st['lam']} candidates, evolved in "
            f"{st['evolve_s']:.2f} s; per generation "
            f"{split[fam]['generation_ms']:.2f} ms = host "
            f"{split[fam]['host_ms']:.2f} + operands on the card to "
            f"scores on the host (K11, reduction, copy back) "
            f"{split[fam]['device_ms']:.2f}")
    tiny = {}
    for engine in ("device", "numpy"):
        tiny[engine], rec = build_library.run("tiny", engine, device, None,
                                              log=log)
        record[f"tiny_{engine}_s"] = rec["wall_s"]
    if not _same_library(tiny["device"], tiny["numpy"]):
        raise AssertionError("the tiny library built on the card differs "
                             "from the host build")
    log(f"tiny library: engine=device on the card equals engine=numpy, "
        f"entry for entry ({len(tiny['numpy'].entries)} entries)")
    record.update(main_path_s=wall, launches=launches,
                  generation_split=split)
    return lib, record


def _prefill_batch(prompts, extras, device) -> dict:
    """The prefill's batch on ``device``: the prompts and the family's
    non-token inputs (``registry.input_extras``), if any."""
    import torch
    return {"tokens": torch.as_tensor(prompts, device=device),
            **{k: torch.as_tensor(v, device=device)
               for k, v in (extras or {}).items()}}


def _teacher_forced(cfg, params, prompts, tokens, policy, device,
                    extras=None):
    """Prefill logits, then the decode logits with ``tokens`` fed back
    (so two policies see the same stream): (max_new, B, V) f32."""
    import torch
    from repro_torch.models.registry import model_fns, prompt_extra_len
    fns = model_fns(cfg)
    b, s = prompts.shape
    rows = s + tokens.shape[1] + prompt_extra_len(cfg, extras)
    with torch.inference_mode():
        cache = fns.init_cache(cfg, b, rows, device)
        logits, cache = fns.forward_prefill(
            params, _prefill_batch(prompts, extras, device), cache, cfg,
            policy)
        out = [logits]
        for i in range(tokens.shape[1] - 1):
            logits, cache = fns.forward_decode(
                params, torch.as_tensor(tokens[:, i], device=device), cache,
                cfg, policy)
            out.append(logits)
        return torch.stack(out).float()


def _checked_generate(engine, prompts, per_step: tuple, rows: list,
                      extras=None) -> dict:
    """One prefill and one decode step through ``engine`` with every K9
    call's output re-checked against the plain version on the same
    codes, within the bound (``_check_lowrank``); fails unless the
    prefill and the step made ``per_step`` K9 calls at the ``rows``
    given."""
    from repro_torch.kernels import datapaths, ref
    from repro_torch.serve import ServeConfig
    real = datapaths.lowrank_matmul
    seen = []

    def checked(qa, qw, u, v):
        y = real(qa, qw, u, v)
        plain = (ref.lowrank_matmul_experts_ref if qw.ndim == 3
                 else ref.lowrank_matmul_ref)
        seen.append((qa.shape[-2], *_check_lowrank(
            y, plain(qa, qw, u, v), qa, qw, u, v,
            f"serve call {len(seen)} {tuple(qa.shape)}x{tuple(qw.shape)}"
        )[:2]))
        return y

    datapaths.lowrank_matmul = checked
    try:
        engine.generate(prompts, ServeConfig(max_new_tokens=2),
                        extras=extras)
    finally:
        datapaths.lowrank_matmul = real
    got_rows = sorted({m for m, _, _ in seen})
    if len(seen) != sum(per_step) or got_rows != sorted(rows):
        raise AssertionError(f"checked serve run made {len(seen)} K9 calls "
                             f"at rows {got_rows}, expected {per_step} at "
                             f"rows {sorted(rows)} over one prefill and one "
                             "decode step")
    return {"calls": len(seen), "rows": got_rows,
            "max_abs_err": max(e for _, e, _ in seen),
            "max_err_over_bound": max(q for _, _, q in seen)}


def _profile_decode(engine, prompts, device, extras=None) -> dict:
    """One decode step of the static engine under ``torch.profiler``
    (``_profiled``)."""
    import torch
    from repro_torch.models.registry import prompt_extra_len
    cfg, fns, policy = engine.cfg, engine.fns, engine.policy
    b, s = prompts.shape
    with torch.inference_mode():
        rows = s + 3 + prompt_extra_len(cfg, extras)
        cache = fns.init_cache(cfg, b, rows, device)
        logits, cache = fns.forward_prefill(
            engine.params, _prefill_batch(prompts, extras, device), cache,
            cfg, policy)
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = fns.forward_decode(engine.params, tok, cache, cfg,
                                           policy)        # warm-up step
        return _profiled(lambda: fns.forward_decode(engine.params, tok,
                                                    cache, cfg, policy))


def _profiled(fn) -> dict:
    """``fn()`` under ``torch.profiler``: its wall, the device's busy
    time (the kernels' own time), the kernels it ran and the top ones,
    and the device memory's peak during it (resident tensors
    included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # the kernels themselves (device-side entries): a host op's own
    # device time repeats the kernels it launched
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]

    def dev_ms(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    busy_ms = sum(dev_ms(e) for e in kernels)
    top = sorted(kernels, key=dev_ms, reverse=True)[:8]
    host = sorted(events, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:8]
    return {"wall_ms": wall_ms,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_busy_ms": busy_ms if busy_ms > 0 else None,
            "busy_share": busy_ms / wall_ms if busy_ms > 0 else None,
            "kernels": sum(e.count for e in kernels),
            "top": [{"name": e.key[:80], "calls": e.count,
                     "device_ms": dev_ms(e)} for e in top],
            "top_host": [{"name": e.key, "calls": e.count,
                          "host_ms": e.self_cpu_time_total / 1e3}
                         for e in host]}


def _serve_path(device, log, launches_total: dict, settings: dict,
                k9_calls) -> dict:
    """``launch.serve.run`` at ``settings`` under ``lowrank``/``pallas``
    (K9 in every projection of every layer, prefill and decode), then its
    gates: K9 launched exactly ``k9_calls(cfg, batch, prompt)`` = (a
    prefill's, a decode step's, the rows of the prefill's and the step's
    calls) times a forward; every K9 call of one prefill and one decode
    step within the bound of the plain version on the same codes; the
    same model under ``variant="ref"`` (plain PyTorch) within
    ``QUANT_RTOL``, teacher-forced; the model's bytes and one profiled
    decode step printed."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.registry import input_extras
    from repro_torch.serve import Engine, ServeConfig
    arch = settings["arch"]
    record, wall, launches = _drive(
        f"serve {arch} (lowrank, pallas)",
        lambda: serve.run(device, **settings, variant="pallas", log=log),
        ("lowrank_matmul",))
    for k, v in launches.items():
        launches_total[k] += v
    dev, cfg, params, prompts = serve.setup(
        device, arch, batch=settings["batch"],
        prompt_len=settings["prompt_len"],
        overrides=settings.get("overrides"))
    extras = input_extras(cfg, settings["batch"]) or None
    n_params = sum(v.numel() for v in _leaves(params))
    per_prefill, per_decode, rows = k9_calls(cfg, *prompts.shape)
    per_generate = per_prefill + (settings["max_new"] - 1) * per_decode
    # warm-up and timed runs: a full generate and a prefill-only one each
    expected = 2 * (per_generate + per_prefill)
    tokens = np.asarray(record["tokens"])
    if (launches["lowrank_matmul"] != expected
            or tokens.shape != (settings["batch"], settings["max_new"])
            or tokens.min() < 0 or tokens.max() >= cfg.vocab):
        raise AssertionError(f"serve {arch} run malformed: K9 launches "
                             f"{launches['lowrank_matmul']} (expected "
                             f"{expected}), tokens {tokens.shape}")
    log(f"serve {arch}: {n_params / 1e9:.3f} B f32 parameters, "
        f"{n_params * 4 / 1e9:.2f} GB; K9 launched {per_prefill} times a "
        f"prefill and {per_decode} a decode step, {per_generate} a "
        f"generate ({expected} in the run); end-to-end "
        f"{record['e2e_s']:.3f} s ({record['tok_per_s']:.2f} tok/s), "
        f"prefill-only generate {record['prefill_s']:.3f} s, steady-state "
        f"decode {record['decode_tok_per_s']:.2f} tok/s, warm-up pair "
        f"{record['warmup_s']:.2f} s")
    pols = {v: serve.make_policy(settings["mode"], record["multiplier"],
                                 settings["rank"], v)
            for v in ("pallas", "ref")}
    engines = {v: Engine(cfg, params, p) for v, p in pols.items()}
    checked = _checked_generate(engines["pallas"], prompts,
                                (per_prefill, per_decode), rows, extras)
    log(f"serve {arch}: {checked['calls']} K9 calls of a prefill and a "
        f"decode step (rows {checked['rows']}) within the bound of the "
        f"plain version on the same codes; max |K9 - plain| "
        f"{checked['max_abs_err']:.3g}, max |K9 - y64| / bound "
        f"{checked['max_err_over_bound']:.3g}")
    cfg_new = ServeConfig(max_new_tokens=settings["max_new"])
    greedy = {v: e.generate(prompts, cfg_new, extras=extras)
              for v, e in engines.items()}
    logits = {v: _teacher_forced(cfg, params, prompts, greedy["pallas"],
                                 p, dev, extras) for v, p in pols.items()}
    d_pre = float((logits["pallas"][0] - logits["ref"][0]).abs().max())
    d_dec = float((logits["pallas"][1:] - logits["ref"][1:]).abs().max())
    agree = float((greedy["pallas"] == greedy["ref"]).mean())
    if not np.array_equal(greedy["pallas"], tokens):
        raise AssertionError("the checked engine's greedy tokens differ "
                             "from the served run's")
    atol = QUANT_RTOL * float(logits["ref"].abs().max())
    log(f"serve {arch}: pallas vs ref on the card: max |d logits| prefill "
        f"{d_pre:.4g}, teacher-forced decode {d_dec:.4g} (tolerance "
        f"{atol:.4g} = {QUANT_RTOL} x the largest |logit|); greedy tokens "
        f"agree {agree:.1%}")
    if not (bool(torch.isfinite(logits["pallas"]).all())
            and d_pre <= atol and d_dec <= atol):
        raise AssertionError(f"{arch} pallas serve logits differ from ref "
                             f"beyond {atol}: {d_pre}, {d_dec}")
    prof = _profile_decode(engines["pallas"], prompts, dev, extras)
    log(f"serve {arch}: one decode step {prof['wall_ms']:.2f} ms under the "
        f"profiler, device busy {prof['device_busy_ms']} ms (share "
        f"{prof['busy_share']}, {prof['kernels']} kernels, peak "
        f"{prof['peak_gb']:.2f} GB); top device "
        f"{prof['top'][:5]}; top host {prof['top_host'][:5]}")
    del engines, params, logits
    torch.cuda.empty_cache()
    return {**record, "main_path_s": wall, "launches": launches,
            "params": n_params, "k9_per_prefill": per_prefill,
            "k9_per_decode": per_decode, "k9_per_generate": per_generate,
            "checked": checked, "pallas_vs_ref": {
                "prefill_max_abs": d_pre, "decode_max_abs": d_dec,
                "atol": atol, "token_agreement": agree},
            "decode_profile": prof}


def phase_serve(device, log, launches_total: dict) -> dict:
    """Path D: qwen1.5-0.5b at full width (``_serve_path``): K9 7 x 24
    times a prefill and a decode step."""
    def k9_calls(cfg, b, s):
        per_forward = PROJECTIONS_PER_LAYER * cfg.n_layers
        return per_forward, per_forward, [b * s, b]
    return _serve_path(device, log, launches_total, SERVE, k9_calls)


def phase_serve_encdec(device, log, launches_total: dict) -> dict:
    """Path G: whisper-large-v3 whole (32 encoder and 32 decoder layers,
    1 500 frames of stub audio embeddings) at full width
    (``_serve_path``): K9 32 x 6 + 32 x 2 + 32 x 8 = 512 times a prefill
    (encoder, cross-KV, decoder) at 1 500 and S rows a sequence, and
    32 x 8 = 256 a decode step."""
    def k9_calls(cfg, b, s):
        return (cfg.n_enc_layers * 6 + cfg.n_layers * (2 + 8),
                cfg.n_layers * 8, [b * cfg.enc_frames, b * s, b])
    return _serve_path(device, log, launches_total, SERVE_ENCDEC, k9_calls)


def _profile_mla_step(device) -> dict:
    """One continuous decode step of deepseek-v2-236b (1 of 60 layers, 4
    slots, 4 multipliers of the serve-load bank, ``pallas``) under
    ``torch.profiler`` (``_profiled``), then one more step with each of
    the latent expansion's calls (``mla.wuk``, ``mla.wuv``) timed
    between two synchronisations: their share of that step's wall."""
    import numpy as np
    import torch
    from repro_torch.approx.layers import ApproxPolicy
    from repro_torch.approx.specs import BackendSpec
    from repro_torch.core.library import get_default_library
    from repro_torch.launch import serve, serve_load
    from repro_torch.serve import ContinuousEngine, ServeConfig
    from repro_torch.serve import engine as engine_mod
    mults = serve_load.MULTIPLIERS[::2]
    dev, cfg, params, prompts = serve.setup(
        device, SERVE_MLA["arch"], batch=4, prompt_len=8,
        overrides=SERVE_MLA["overrides"])
    engine = ContinuousEngine(
        cfg, params, library=get_default_library(),
        multipliers=serve_load.MULTIPLIERS, n_slots=4,
        capacity=serve_load.capacity(cfg), variant="pallas")
    for row, mult in zip(prompts, mults):
        engine.submit(row, ServeConfig(max_new_tokens=8, policy=ApproxPolicy(
            default=BackendSpec(mode="lut", multiplier=mult,
                                ste=False)).to_json()))
    engine.step()                       # 4 prefills + the first step
    engine.step()                       # warm-up decode step
    prof = _profiled(engine.step)
    last = engine.step_log[-1]
    spent = []
    matmul = engine_mod._CountedPolicy.matmul

    def timed(self, name, x, w, lanes=False, experts=False):
        if not name.endswith((".wuk", ".wuv")):
            return matmul(self, name, x, w, lanes, experts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = matmul(self, name, x, w, lanes, experts)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return y

    engine_mod._CountedPolicy.matmul = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    finally:
        engine_mod._CountedPolicy.matmul = matmul
    if last["kind"] != "decode" or last["lanes"] != 4 or len(spent) != 2 \
            * cfg.n_layers:
        raise AssertionError(f"profiled MLA step malformed: {last}, "
                             f"{len(spent)} expansion calls")
    prof.update(lanes=last["lanes"], launches=last["launches"],
                view_rows=int(np.max(engine._lengths)) + 1,
                timed_step_ms=step_s * 1e3,
                expansion_ms=sum(spent) * 1e3,
                expansion_share=sum(spent) / step_s)
    del engine, params
    torch.cuda.empty_cache()
    return prof


def phase_serve_families(device, log, launches_total: dict) -> dict:
    """Path H: continuous serving of every family.  Each config of
    ``SERVE_FAMILIES`` through ``launch.serve_load.run`` under ``pallas``
    (K2), deepseek-v2-236b also under ``fused`` (K4), each failing
    unless every request's tokens equal its sequential
    ``Engine.generate`` under ``lane_policy`` (K1 / K3), every prefill
    and decode step launched the banked kernel exactly as the call-site
    formula says (``serve_load.banked_calls_per_step``) and nothing
    else, and the bank was built once; deepseek's fused tokens must equal
    its pallas tokens.  Each run's wall, tokens/s, decode step wall and
    launches are printed; then one MLA decode step profiled, with the
    latent expansion's share of a step; then the static MLA serve
    (``_serve_path``: deepseek-v2-236b at 1 of 60 layers under
    ``lowrank``/``pallas``, K9 14 times a prefill and a decode step, a
    routed-expert projection one launch for its 160 experts, within the
    bound and 2.5% of ``ref``)."""
    import torch
    from repro_torch.launch import serve_load
    out, tokens = {}, {}
    runs = [(f, a, kw, "pallas") for f, a, kw in SERVE_FAMILIES]
    runs += [(f, a, kw, "fused") for f, a, kw in SERVE_FAMILIES
             if a == SERVE_FAMILY_FUSED]
    for family, arch, kw, variant in runs:
        kernels = CONTINUOUS_KERNELS[variant]
        name = f"serve_load {family} {arch} ({variant})"
        record, wall, launches = _drive(
            name, lambda: serve_load.run(
                device, arch=arch, variant=variant, log=log,
                **SERVE_FAMILY_LOAD, **kw), kernels)
        per = {"prefill": record["banked_per_prefill_expected"],
               "decode": record["banked_per_step_expected"]}
        steps = record["steps"]
        banked = sum(steps[k]["n"] * per[k] for k in per)
        lv = record["levels"][0]
        if (not record["bit_identity"] or not record["banked_per_step_gate"]
                or record["bank_builds"] != 1
                or record["bit_identity_requests"] != 4
                or launches[kernels[0]] != banked):
            raise AssertionError(
                f"{name}: bit identity {record['bit_identity']}, banked "
                f"gate {record['banked_per_step_gate']}, bank builds "
                f"{record['bank_builds']}, {kernels[0]} "
                f"{launches[kernels[0]]} (formula {banked}): {steps}")
        log(f"{name}: {record['n_layers']} layers, wall {lv['wall_s']:.3f} "
            f"s, {lv['tokens_per_s']:.2f} tok/s ({lv['n_tokens']} tokens, "
            f"p50 {lv['p50_ms']:.1f} ms, p99 {lv['p99_ms']:.1f} ms); 4 "
            f"requests equal the sequential replay ({record['replay_s']:.2f}"
            f" s)")
        log(f"{name}: decode step {lv['decode_step_ms']:.2f} ms (median of "
            f"{steps['decode']['n']}); {kernels[0]} {per['decode']} a decode "
            f"step and {per['prefill']} a prefill, nothing else, as the "
            f"formula says")
        tokens[(arch, variant)] = record["tokens"]
        for k, v in launches.items():
            launches_total[k] += v
        out[f"{arch}_{variant}"] = {**record, "family": family,
                                    "main_path_s": wall,
                                    "launches": launches}
        torch.cuda.empty_cache()
    if tokens[(SERVE_FAMILY_FUSED, "fused")] != \
            tokens[(SERVE_FAMILY_FUSED, "pallas")]:
        raise AssertionError(f"{SERVE_FAMILY_FUSED}: fused tokens differ "
                             "from pallas")
    log(f"serve_load {SERVE_FAMILY_FUSED}: fused tokens equal pallas")
    prof = _profile_mla_step(device)
    log(f"[profile] continuous MLA step (deepseek-v2-236b, 1 layer, 4 "
        f"slots, {prof['view_rows']}-row views): {prof['wall_ms']:.2f} ms "
        f"under the profiler, device busy {prof['device_busy_ms']} ms "
        f"(share {prof['busy_share']}, {prof['kernels']} kernels, launches "
        f"{prof['launches']}); the latent expansion (wuk + wuv) "
        f"{prof['expansion_ms']:.2f} ms of a {prof['timed_step_ms']:.2f} ms "
        f"step ({prof['expansion_share']:.1%}); top device {prof['top'][:5]}")
    out["mla_step_profile"] = prof

    def k9_calls(cfg, b, s):
        from repro_torch.models.moe import capacity
        # the call-site formula: one call a projection, a routed-expert
        # projection one K9 launch for all its experts (the expert form)
        per_forward = serve_load.banked_calls_per_step(cfg)["decode"]
        # projections at b*s (prefill) or b (decode) rows, wuk/wuv over
        # the whole cache (the checked generate's s + 2 rows), the routed
        # experts at their capacity
        rows = {b * s, b, b * (s + 2), capacity(cfg, b * s), capacity(cfg, b)}
        return per_forward, per_forward, sorted(rows)
    out["serve_mla"] = _serve_path(device, log, launches_total, SERVE_MLA,
                                   k9_calls)
    return out


def _resnet_accuracies(model, device) -> dict:
    """Float and golden 8-bit accuracy on the 256 eval images."""
    from repro_torch.approx.layers import ApproxPolicy
    from repro_torch.approx.specs import BackendSpec
    from repro_torch.approx.workload import classification
    from repro_torch.models import resnet
    wl = classification(resnet.resnet_config(8), model, eval_n=EVAL_N,
                        batch=BATCH, device=device)
    return {"f32": wl(ApproxPolicy(default=BackendSpec.exact("f32"))),
            "int8": wl(ApproxPolicy(default=BackendSpec.golden()))}


def _conv_weights(model) -> list:
    """ResNet-8's matmul weights in forward order (conv_init, each
    block's conv1, conv2, proj, then the head)."""
    ws = [model.conv_init.w]
    for blk in model.blocks.values():
        ws += [blk.conv1.w, blk.conv2.w]
        if hasattr(blk, "proj"):
            ws.append(blk.proj.w)
    return ws + [model.head.w]


def _check_ste_step(device, policy_json: dict, variant: str) -> dict:
    """One STE step of the committed ResNet-8 under the fine-tune's
    policy on the card: every matmul's output equals its plain datapath
    (``variant="ref"``) on the same operands bit for bit, and every
    weight gradient equals ``torch.matmul(x2d.T, g)`` of the operands
    and the incoming gradient bit for bit."""
    import dataclasses
    import torch
    from repro_torch.approx import backend
    from repro_torch.approx.layers import ApproxPolicy
    from repro_torch.core.library import get_default_library
    from repro_torch.data.synthetic import CifarBatches
    from repro_torch.models import resnet
    from repro_torch.models.weights import load_resnet8
    lib = get_default_library()
    policy = ApproxPolicy.from_json_dict(policy_json).materialize(lib)
    model = load_resnet8().to(device)
    b = next(CifarBatches("train", BATCH, BATCH).epoch())
    batch = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    calls = []
    real = backend._SteMatmul

    class Spy:
        @staticmethod
        def apply(x2d, w, mb):
            y = real.apply(x2d, w, mb)
            call = {"x": x2d.detach(), "w": w.detach(), "mb": mb,
                    "y": y.detach()}
            y.register_hook(lambda g, c=call: c.__setitem__("g", g))
            calls.append(call)
            return y

    backend._SteMatmul = Spy
    try:
        resnet.loss_fn(model, batch, resnet.resnet_config(8),
                       policy).backward()
        torch.cuda.synchronize()
    finally:
        backend._SteMatmul = real
    weights = _conv_weights(model)
    if len(calls) != len(weights):
        raise AssertionError(f"STE step ({variant}): {len(calls)} matmuls, "
                             f"want {len(weights)}")
    approx = 0
    for call, w in zip(calls, weights):
        mb = call["mb"]
        approx += mb.spec.variant == variant
        plain = dataclasses.replace(mb.spec, variant="ref").materialize(lib)
        want_y = backend._forward(call["x"], call["w"], plain, False)
        g_w = w.grad if w.ndim == 2 else \
            w.grad.permute(2, 0, 1, 3).reshape(-1, w.shape[-1])
        want_g = torch.matmul(call["x"].to(torch.float32).T,
                              call["g"].to(torch.float32))
        if not (torch.equal(call["y"], want_y) and torch.equal(g_w, want_g)
                and torch.isfinite(g_w).all()):
            raise AssertionError(f"STE step ({variant}): layer output or "
                                 f"weight gradient differs at {mb.spec}")
    print(f"[train] STE step ({variant}): {len(calls)} matmuls, {approx} "
          f"on the {variant} datapath: outputs equal the plain datapath's "
          f"and weight gradients equal torch.matmul(x2d.T, g), bit for bit")
    return {"matmuls": len(calls), "approximate": approx}


def _train_resnet_phase(device, log, tmp: str, launches_total: dict
                        ) -> dict:
    """(a) ``train_resnet``'s recipe from a seeded init; (b) its
    sweeps, heterogeneous DSE and STE fine-tune from the committed
    checkpoint under each variant."""
    import numpy as np
    from repro_torch.launch import train_resnet
    from repro_torch.models.weights import load_resnet8
    out = {}
    (cfg, model, hist, _), wall, launches = _drive(
        "ResNet-8 training (320 steps, f32)",
        lambda: train_resnet.train(device, 8, 320, BATCH, 4096,
                                   ckpt_dir=os.path.join(tmp, "resnet"),
                                   log=lambda s: None), ())
    losses = [h["loss"] for h in hist]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not (len(losses) == 320 and np.isfinite(losses).all()
            and last < first):
        raise AssertionError(f"ResNet-8 training: losses {first} -> {last}")
    step_ms = float(np.median([h["ms"] for h in hist[1:]]))
    accs = {"trained": _resnet_accuracies(model, device),
            "committed": _resnet_accuracies(load_resnet8(), device)}
    print(f"[train] ResNet-8 on {_smi('name,power.limit')}: 320 steps in "
          f"{wall:.2f} s (median step {step_ms:.2f} ms), loss {first:.4f} "
          f"-> {last:.4f}; accuracy float / 8-bit {accs['trained']} "
          f"(committed checkpoint: {accs['committed']})")
    out["resnet_train"] = {"wall_s": wall, "step_ms": step_ms,
                           "losses": losses, "accuracy": accs}
    for variant in ("pallas", "fused"):
        single, bank = HETERO_KERNELS[variant]
        record, wall, launches = _drive(
            f"ResNet-8 sweeps + STE fine-tune ({variant})",
            lambda: train_resnet.run(
                device, steps=320, eval_n=EVAL_N, n_mult=6,
                from_checkpoint=True, variant=variant,
                ckpt_dir=os.path.join(tmp, f"ft_{variant}"), log=log),
            (single, bank))
        ft = record["fine_tune"]
        if ft is None:
            raise AssertionError(f"fine-tune ({variant}): no heterogeneous "
                                 "point within the bound")
        layers = len(ft["assignment"])
        want = {single: layers * ft["steps"]}
        want_eval = {single: layers * ft["eval_batches"]}
        if (ft["launches"] != want or ft["eval_launches"] != want_eval
                or ft["eval_launches_after"] != want_eval
                or not np.isfinite(ft["losses"]).all()):
            raise AssertionError(
                f"fine-tune ({variant}): launches {ft['launches']} (want "
                f"{want}), evaluations {ft['eval_launches']} / "
                f"{ft['eval_launches_after']} (want {want_eval})")
        step = _check_ste_step(device, ft["policy"], variant)
        print(f"[train] fine-tune ({variant}): {ft['steps']} STE steps, "
              f"{want} launches ({layers} layers a step), median step "
              f"{ft['step_ms']:.2f} ms; accuracy under the policy "
              f"{ft['accuracy_before']:.4f} -> {ft['accuracy_after']:.4f} "
              f"(verified {ft['verified_accuracy']:.4f}, power "
              f"{ft['network_rel_power']:.4f})")
        out[f"resnet_fine_tune_{variant}"] = {
            **record, "main_path_s": wall, "launches": launches,
            "ste_step": step}
        for k, v in launches.items():
            launches_total[k] += v
    return out


def _lm_train_phase(device, tmp: str) -> dict:
    """(c) ``launch.train`` on qwen1.5-0.5b at full width, then a resume
    into fresh tensors, equal bit for bit to the trained state."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.train.optimizer import tree_leaves
    ckpt = os.path.join(tmp, "lm")
    rec, wall, _ = _drive(
        f"{LM_TRAIN['arch']} training",
        lambda: train.run(device, ckpt_dir=ckpt, keep=1,
                          log=lambda s: None, **LM_TRAIN), ())
    losses = [h["loss"] for h in rec["history"]]
    if not (len(losses) == LM_TRAIN["steps"] and np.isfinite(losses).all()
            and rec["last_loss"] < rec["first_loss"]):
        raise AssertionError(f"LM training: losses {losses}")
    first = rec.pop("trainer")
    cfg = get_config(LM_TRAIN["arch"])
    t0 = time.perf_counter()
    resumed = train.make_trainer(cfg, train.init_params(cfg, device, 1),
                                 LM_TRAIN["steps"], 3e-4, 1, ckpt, keep=1)
    if not resumed.maybe_resume() or resumed.step != LM_TRAIN["steps"]:
        raise AssertionError("LM resume found no checkpoint")
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    pairs = list(zip(tree_leaves((resumed.params, resumed.opt_state)),
                     tree_leaves((first.params, first.opt_state))))
    bad = [k for (k, a), (_, b) in pairs if not torch.equal(a, b)]
    if bad or len(pairs) != 3 * len(tree_leaves(first.params)) + 1:
        raise AssertionError(f"LM resume differs at {bad[:5]}")
    ckpt_bytes = sum(os.path.getsize(os.path.join(d, f))
                     for d, _, fs in os.walk(ckpt) for f in fs)
    del first, resumed
    torch.cuda.empty_cache()
    gib = rec["peak_bytes"] / 2 ** 30
    print(f"[train] {LM_TRAIN['arch']} at full width on "
          f"{_smi('name,power.limit')}: {rec['n_params'] / 1e9:.3f} B "
          f"parameters, {LM_TRAIN['steps']} steps at batch "
          f"{LM_TRAIN['batch']} x {LM_TRAIN['seq']}: loss "
          f"{rec['first_loss']:.4f} -> {rec['last_loss']:.4f}; median step "
          f"{rec['step_ms']:.1f} ms (max {rec['step_ms_max']:.1f}), "
          f"{rec['tokens_per_s']:.0f} tokens/s at the median step, "
          f"{rec['tokens_per_s_steps']:.0f} over all steps, "
          f"{rec['tokens_per_s_run']:.0f} over the run with its saves, "
          f"peak {gib:.2f} GiB; run {wall:.1f} s with its checkpoints; "
          f"resume of {len(pairs)} leaves bit for bit in {resume_s:.1f} s "
          f"({ckpt_bytes / 2 ** 30:.2f} GiB on disk)")
    return {"lm_train": {**rec, "wall_s": wall, "resume_s": resume_s,
                         "checkpoint_bytes": ckpt_bytes,
                         "peak_gib": gib}}


def _perplexity_phase(device, launches_total: dict) -> dict:
    """(d) banked ``lm_perplexity`` sweeps on reduced qwen1.5-0.5b equal
    to sequential ones bit for bit, one banked launch a projection a
    pass."""
    from repro_torch.approx.dse import explore
    from repro_torch.approx.workload import lm_perplexity
    from repro_torch.configs import get_config
    from repro_torch.core.library import get_default_library
    from repro_torch.launch.case_study import case_study_names
    lib = get_default_library()
    names = case_study_names(lib, 3)
    n_batches = 2
    wl = lm_perplexity(LM_TRAIN["arch"], batch=2, seq_len=16,
                       n_batches=n_batches, device=device)
    per_pass = (PROJECTIONS_PER_LAYER
                * get_config(LM_TRAIN["arch"]).reduced().n_layers
                * n_batches)
    out, rows = {}, {}
    for variant in ("pallas", "fused"):
        single, bank = HETERO_KERNELS[variant]
        kw = dict(workload=wl, library=lib, multipliers=names, mode="lut",
                  variant=variant, per_layer=False)
        banked, wall, launches = _drive(
            f"lm_perplexity banked sweep ({variant})",
            lambda: explore(batch=True, **kw), (bank,))
        seq, seq_wall, seq_launches = _drive(
            f"lm_perplexity sequential sweep ({variant})",
            lambda: explore(batch=False, **kw), (single,))
        rows[variant] = [p.metrics for p in banked.all_layers]
        if (rows[variant] != [p.metrics for p in seq.all_layers]
                or launches != {**{k: 0 for k in launches}, bank: per_pass}
                or seq_launches[single] != per_pass * len(names)):
            raise AssertionError(
                f"lm_perplexity ({variant}): banked == sequential "
                f"{rows[variant] == [p.metrics for p in seq.all_layers]}, "
                f"launches {launches} / {seq_launches} (want {per_pass} a "
                f"pass)")
        for src in (launches, seq_launches):
            for k, v in src.items():
                launches_total[k] += v
        out[variant] = {"rows": rows[variant], "banked_s": wall,
                        "sequential_s": seq_wall, "launches": launches,
                        "sequential_launches": seq_launches}
    if rows["fused"] != rows["pallas"]:
        raise AssertionError(f"lm_perplexity rows differ between "
                             f"variants: {rows}")
    print(f"[train] lm_perplexity ({len(names)} multipliers, reduced "
          f"{LM_TRAIN['arch']}): banked == sequential bit for bit, "
          f"{per_pass} banked launches a pass, fused rows == pallas rows; "
          f"banked {out['pallas']['banked_s']:.3f} / "
          f"{out['fused']['banked_s']:.3f} s, sequential "
          f"{out['pallas']['sequential_s']:.3f} / "
          f"{out['fused']['sequential_s']:.3f} s (pallas / fused)")
    return {"lm_perplexity": out}


def phase_train(device, log, launches_total: dict) -> dict:
    """Path H: training on the card (``_train_resnet_phase``,
    ``_lm_train_phase``, ``_perplexity_phase``), its checkpoints in a
    temporary directory removed at the end."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        out = _train_resnet_phase(device, log, tmp, launches_total)
        out.update(_lm_train_phase(device, tmp))
        out.update(_perplexity_phase(device, launches_total))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _check_against_objectives_bench(record) -> None:
    """The ResNet scenario's weight-independent fields against the
    reference's recorded ``--quick`` run (``BENCH_OBJECTIVES``): the
    candidates, the 2-D gate, the members of both fronts, every accuracy
    within one image, the same ``select`` pick."""
    with open(BENCH_OBJECTIVES) as f:
        want = json.load(f)["resnet"]
    got = record["resnet"]
    tol = 1 / got["eval_n"]
    bad = []
    for key in ("candidates", "bit_identical_2d"):
        if got[key] != want[key]:
            bad.append(f"{key}: {got[key]} != {want[key]}")
    for key in ("pareto_2d", "pareto_3d"):
        names = [p["multiplier"] for p in got[key]]
        if names != [p["multiplier"] for p in want[key]]:
            bad.append(f"{key}: {names}")
    for g, w in zip(got["sweep"], want["sweep"]):
        if (g["multiplier"] != w["multiplier"]
                or abs(g["accuracy"] - w["accuracy"]) > tol
                or g["power"] != w["power"] or g["delay"] != w["delay"]):
            bad.append(f"sweep: {g} != {w}")
    if (got["selected"] or {}).get("multiplier") != \
            (want["selected"] or {}).get("multiplier"):
        bad.append(f"selected {got['selected']} != {want['selected']}")
    if bad:
        raise AssertionError("objectives --quick study differs from the "
                             "reference's recorded run: " + "; ".join(bad))
    print(f"[main] objectives (--quick, {record['variant']}) equals the "
          f"reference's recorded run "
          f"({os.path.relpath(BENCH_OBJECTIVES, ROOT)}): "
          f"{len(want['candidates'])} candidates, fronts "
          f"{[p['multiplier'] for p in want['pareto_2d']]}, selection "
          f"{want['selected']['multiplier']}, accuracies within {tol}")


def phase_objectives(device, log, launches_total: dict) -> dict:
    """Path I: ``objectives_pareto.run`` at ``--quick`` under each
    variant (its gates; the ResNet scenario against
    ``BENCH_objectives.json``; each sweep's banked launches — 10 layers
    x eval batches for the ResNet, 7 projections x 2 layers x 2 batches
    for the decoder — and the sequential decoder sweep's; fused rows ==
    pallas rows), then once at the default 256 images under
    ``pallas``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import objectives_pareto
    out, rows = {}, {}
    per_lm_pass = (PROJECTIONS_PER_LAYER
                   * get_config(objectives_pareto.DECODER_ARCH).reduced()
                   .n_layers * 2)
    runs = [("pallas", True), ("fused", True), ("pallas", False)]
    for variant, quick in runs:
        single, bank = HETERO_KERNELS[variant]
        label = f"{variant}{' --quick' if quick else ''}"
        record, wall, launches = _drive(
            f"objectives study ({label})",
            lambda: objectives_pareto.run(device, quick=quick,
                                          variant=variant, log=log),
            (single, bank))
        rn, lm = record["resnet"], record["decoder"]
        want_rn = {bank: 10 * (rn["eval_n"] // BATCH)}
        want_seq = {single: per_lm_pass * len(lm["candidates"])}
        if (rn["launches"] != want_rn
                or lm["batched_launches"] != {bank: per_lm_pass}
                or lm["sequential_launches"] != want_seq):
            raise AssertionError(
                f"objectives ({label}): launches {rn['launches']} / "
                f"{lm['batched_launches']} / {lm['sequential_launches']} "
                f"(want {want_rn} / {per_lm_pass} / {want_seq})")
        if quick:
            _check_against_objectives_bench(record)
            rows[variant] = (rn["sweep"], lm["sweep"])
        print(f"[main] objectives ({label}) on {_smi('name,power.limit')}: "
              f"ResNet sweep {rn['sweep_s']:.3f} s, decoder banked "
              f"{lm['batched_s']:.3f} s / sequential "
              f"{lm['sequential_s']:.3f} s; selected "
              f"{rn['selected']['multiplier']} / "
              f"{lm['selected']['multiplier']}")
        out[label.replace(" --", "_")] = {**record, "main_path_s": wall,
                                          "launches": launches}
        for k, v in launches.items():
            launches_total[k] += v
    if rows["fused"] != rows["pallas"]:
        raise AssertionError(f"objectives rows differ between variants: "
                             f"{rows}")
    print("[main] objectives (--quick): fused rows == pallas rows")
    return out


def phase_evolve(device, log, launches_total: dict) -> dict:
    """Path J: ``evolve_library.run`` at its default size against
    ``BENCH_evolve.json``: metric identity, the ladder (rungs,
    generations, circuits, candidate evaluations, archive sizes in
    order), the ``tiny`` builds' entries and evolved counts; the
    throughput ratio recorded, not gated."""
    from repro_torch.launch import evolve_library
    record, wall, launches = _drive(
        "evolve study", lambda: evolve_library.run(device, log=log),
        ("bitsim_pop", "bitsim"))
    with open(BENCH_EVOLVE) as f:
        want = json.load(f)
    lad, wlad = record["ladder"], want["ladder"]
    bad = []
    if record["metric_identity"] != want["metric_identity"]:
        bad.append(f"metric identity {record['metric_identity']}")
    for key in ("rungs", "generations", "circuits", "candidate_evals"):
        if lad[key] != wlad[key]:
            bad.append(f"ladder {key} {lad[key]} != {wlad[key]}")
    if ([p["archive_size"] for p in lad["archive_vs_wall_clock"]]
            != [p["archive_size"] for p in wlad["archive_vs_wall_clock"]]):
        bad.append("ladder archive sizes")
    for engine in ("legacy", "device"):
        for key in ("entries", "evolved"):
            if (record["library_tiny"][engine][key]
                    != want["library_tiny"][engine][key]):
                bad.append(f"library_tiny {engine} {key}")
    if bad:
        raise AssertionError("evolve study differs from the reference's "
                             "recorded run: " + "; ".join(bad))
    tp = record["throughput"]
    print(f"[main] evolve study on {_smi('name,power.limit')} equals the "
          f"reference's recorded run ({os.path.relpath(BENCH_EVOLVE, ROOT)}"
          f"): metric identity, ladder {lad['circuits']} circuits / "
          f"{lad['candidate_evals']} evaluations in {lad['wall_s']:.3f} s, "
          f"tiny builds {want['library_tiny']['legacy']['entries']} / "
          f"{want['library_tiny']['device']['entries']} entries; "
          f"throughput numpy {tp['evals_per_s_numpy']:.1f}/s, device "
          f"{tp['evals_per_s_device']:.1f}/s, {tp['speedup']:.2f}x "
          f"(the reference's 3x gate recorded: "
          f"{'met' if tp['speedup_gate_met'] else 'missed'})")
    for k, v in launches.items():
        launches_total[k] += v
    return {**record, "main_path_s": wall, "launches": launches}


class _LaneCalls:
    """Within the block, ``kernels.datapaths``' banked calls (and
    ``ops.bitsim_pop_planes``) record each call's lane (candidate) count
    by name; restored on exit."""

    NAMES = ("approx_matmul_lut_bank", "fused_matmul_lut_bank",
             "composed_matmul_lut_bank", "fused_composed_matmul_lut_bank")

    def __enter__(self):
        from repro_torch.kernels import datapaths, ops
        self.calls = {n: [] for n in self.NAMES + ("bitsim_pop_planes",)}
        self._orig = [(datapaths, n, getattr(datapaths, n))
                      for n in self.NAMES]
        self._orig.append((ops, "bitsim_pop_planes", ops.bitsim_pop_planes))
        for mod, name, fn in self._orig:
            def counted(a, *rest, _fn=fn, _name=name, **kw):
                lanes = (a.shape[0] if _name == "bitsim_pop_planes"
                         else rest[1].shape[0])
                self.calls[_name].append(int(lanes))
                return _fn(a, *rest, **kw)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._orig:
            setattr(mod, name, fn)

    def made(self) -> dict:
        return {k: v for k, v in self.calls.items() if v}


def _mesh_pair(label: str, plain, sharded, kernel: str, shards: int,
               lanes: int, log, timed: dict, launches_total: dict,
               call: str = None):
    """Run ``plain()`` then ``sharded()``, each with the launch counters
    zeroed just before it and read just after; fails unless ``sharded``
    launched ``kernel`` ``shards`` times as often as ``plain`` and
    nothing else, each banked call (``call``) with ``lanes`` lanes.
    Returns both results."""
    import torch
    from repro_torch.kernels import ops
    walls, counts = {}, {}
    outs = []
    for which, fn in (("unsharded", plain), ("sharded", sharded)):
        ops.reset_launch_counts()
        with _LaneCalls() as lc:
            t0 = time.perf_counter()
            outs.append(fn())
            torch.cuda.synchronize()
            walls[which] = time.perf_counter() - t0
        counts[which] = {k: v for k, v in ops.launch_counts().items() if v}
        made = lc.made()
        for k, v in counts[which].items():
            launches_total[k] += v
    base = counts["unsharded"].get(kernel, 0)
    want = {kernel: shards * base}
    if base <= 0 or counts["sharded"] != want:
        raise AssertionError(f"{label}: sharded launches "
                             f"{counts['sharded']}, want {want} (unsharded "
                             f"{counts['unsharded']})")
    if call is not None and made != {call: [lanes] * (shards * base)}:
        raise AssertionError(f"{label}: banked calls {made}, want "
                             f"{shards * base} of {lanes} lanes")
    log(f"{label}: sharded {walls['sharded']:.3f} s, unsharded "
        f"{walls['unsharded']:.3f} s; {kernel} {shards} x {base} launches "
        f"of {lanes} lanes a call")
    timed[label] = {"sharded_s": walls["sharded"],
                    "unsharded_s": walls["unsharded"],
                    "launches": counts["sharded"],
                    "unsharded_launches": counts["unsharded"],
                    "shards": shards, "lanes_a_call": lanes}
    return outs


def _mesh_sweeps(device, log, two, one, timed: dict, launches_total: dict):
    """The case study's and the wide study's all-layers sweeps, sharded
    against unsharded, rows equal."""
    from repro_torch.approx.resilience import all_layers_sweep
    from repro_torch.approx.workload import classification
    from repro_torch.core.library import get_default_library
    from repro_torch.launch.case_study import case_study_names
    from repro_torch.launch.mesh import bank_sharding
    from repro_torch.launch.wide_pareto import wide_names
    from repro_torch.models import resnet
    from repro_torch.models.weights import load_resnet8
    lib = get_default_library()
    wl = classification(resnet.resnet_config(8), load_resnet8(),
                        eval_n=EVAL_N, batch=BATCH, device=device)
    counts = wl.layer_counts
    names = case_study_names(lib, 16)
    wide = case_study_names(lib, 6) + wide_names(lib)
    if len(names) != N_LANES or len(wide) != 12:
        raise AssertionError(f"mesh phase banks: {len(names)} / "
                             f"{len(wide)} lanes")
    rows = {}
    cases = [(variant, n, cands, mesh, tag)
             for variant in MESH_KERNELS
             for n, cands, mesh, tag in (
                 (16, names[:16], two, "16 lanes 8 + 8"),
                 (17, names, two, "17 lanes whole"),
                 (16, names[:16], one, "16 lanes on sweep_mesh()"),
                 (12, wide, two, "12 mixed-width lanes 6 + 6"))
             if variant == "pallas" or "sweep_mesh" not in tag]
    for variant, n, cands, mesh, tag in cases:
        sh = bank_sharding(n, mesh)
        shards = len(sh.shards(n))
        kernel = MESH_KERNELS[variant][n == 12]
        call = MESH_CALLS[variant][n == 12]

        def sweep(sharding=None):
            return [r.metrics for r in all_layers_sweep(
                wl, counts, cands, lib, mode="lut", variant=variant,
                batch=True, sharding=sharding)]

        plain, split = _mesh_pair(
            f"all-layers sweep {tag} ({variant})", sweep,
            lambda: sweep(sh), kernel, shards, n // shards, log, timed,
            launches_total, call)
        if split != plain:
            raise AssertionError(f"sharded sweep {tag} ({variant}) "
                                 f"differs: {split} != {plain}")
        rows[f"{variant} {tag}"] = split
    return rows


def _mesh_verification(device, log, two, hetero: dict, timed: dict,
                       launches_total: dict):
    """The heterogeneous study's batched verification of its verified
    assignments, rows split with ``assign_sharding``."""
    from repro_torch.approx.dse import verify_assignments
    from repro_torch.approx.workload import classification
    from repro_torch.core.library import get_default_library
    from repro_torch.launch.mesh import bank_sharding, policy_sharding
    from repro_torch.models import resnet
    from repro_torch.models.weights import load_resnet8
    lib = get_default_library()
    wl = classification(resnet.resnet_config(8), load_resnet8(),
                        eval_n=hetero["eval_n"], batch=hetero["batch"],
                        device=device)
    assignments = [p["assignment"] for p in hetero["heterogeneous"]]
    k = len(assignments)
    mults = hetero["multipliers"]
    out = {"assignments": k}
    for variant in MESH_KERNELS:
        sh = policy_sharding(k, two)
        shards = len(sh.shards(k))

        def verify(sharded=False):
            pts = verify_assignments(
                wl, assignments, wl.layer_counts, lib, mode="lut",
                variant=variant, batch=True,
                sharding=bank_sharding(len(mults), two) if sharded else None,
                assign_sharding=sh if sharded else None)
            return [(p.accuracy, p.network_rel_power) for p in pts]

        plain, split = _mesh_pair(
            f"verification of {k} assignments ({variant})", verify,
            lambda: verify(True), MESH_KERNELS[variant][0], shards,
            k // shards, log, timed, launches_total, MESH_CALLS[variant][0])
        if split != plain:
            raise AssertionError(f"sharded verification ({variant}) "
                                 f"differs from the unsharded one")
        out[variant] = split
    return out


def _mesh_cgp(device, log, two, timed: dict, launches_total: dict):
    """One mul8 generation (32 offspring of the padded seed) and a short
    ladder on the device engine, the population split with
    ``pop_sharding``: scores and trajectories equal; K10 re-verifies each
    rung's final circuit."""
    import numpy as np
    from repro_torch.core.cgp import CgpParams, mutate, pad_nodes
    from repro_torch.core.evolve_pop import (POP_PAD, PopEvaluator,
                                             evolve_ladder)
    from repro_torch.core.seeds import array_multiplier
    from repro_torch.launch.mesh import pop_sharding
    exact = array_multiplier(8)
    params = CgpParams(metric="mae", seed=1234,
                       generations=MESH_LADDER["generations"])
    padded = pad_nodes(exact, exact.n_nodes, seed=1334)
    rng = np.random.default_rng(1234)
    pop = [mutate(padded, rng, params.h) for _ in range(32)]
    sh = pop_sharding(POP_PAD, two)
    ev_plain = PopEvaluator(exact, params, engine="device", device=device)
    ev_split = PopEvaluator(exact, params, engine="device", sharding=sh)
    plain, split = _mesh_pair(
        "mul8 generation, 32 offspring", lambda: ev_plain.errors_of(pop),
        lambda: ev_split.errors_of(pop), "bitsim_pop", 2, 16, log, timed,
        launches_total, "bitsim_pop_planes")
    if not np.array_equal(plain, split):
        raise AssertionError("sharded mul8 generation scores differ")
    max_out = float((2 ** 8 - 1) ** 2)
    ladder = [max_out * (2.0 ** -e) for e in
              np.linspace(14, 4, MESH_LADDER["rungs"])]

    def run(sharding=None):
        res = evolve_ladder(padded, exact, ladder, params, engine="device",
                            device=device, sharding=sharding)
        return [(r.netlist.to_dict(), r.errors.as_dict()) for r in res]

    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    lad_plain = run()
    plain_s = time.perf_counter() - t0
    plain_launches = {k: v for k, v in ops.launch_counts().items() if v}
    ops.reset_launch_counts()
    with _LaneCalls() as lc:
        t0 = time.perf_counter()
        lad_split = run(sh)
        split_s = time.perf_counter() - t0
    split_launches = {k: v for k, v in ops.launch_counts().items() if v}
    for k, v in list(plain_launches.items()) + list(split_launches.items()):
        launches_total[k] += v
    gens = 1 + MESH_LADDER["generations"]
    rungs = MESH_LADDER["rungs"]
    if (lad_split != lad_plain
            or plain_launches != {"bitsim_pop": gens, "bitsim": rungs}
            or split_launches != {"bitsim_pop": 2 * gens, "bitsim": rungs}
            or lc.made() != {"bitsim_pop_planes":
                             [4] * 2 + [rungs * params.lam // 2] * (
                                 2 * (gens - 1))}):
        raise AssertionError(f"sharded ladder: trajectories equal "
                             f"{lad_split == lad_plain}, launches "
                             f"{split_launches} / {plain_launches}, "
                             f"calls {lc.made()}")
    log(f"ladder of {rungs} rungs x {MESH_LADDER['generations']} "
        f"generations: sharded {split_s:.3f} s, unsharded {plain_s:.3f} s; "
        f"bitsim_pop 2 x {gens} launches, bitsim {rungs} (re-verification); "
        f"trajectories equal")
    timed["ladder"] = {"sharded_s": split_s, "unsharded_s": plain_s,
                       "launches": split_launches,
                       "unsharded_launches": plain_launches}
    return {"generation": list(split), "ladder": [
        {"errors": e} for _n, e in lad_split]}


def _mesh_serve(device, log, two, timed: dict, launches_total: dict):
    """``ContinuousEngine`` over 4 slots split 2 + 2 against the whole
    engine on the same Poisson requests; tokens equal each other and
    the sequential replay; every decode step launched K2 168 times a
    shard that ran."""
    import numpy as np
    import torch
    from repro_torch.core.library import get_default_library
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_load
    from repro_torch.launch.mesh import slot_sharding
    from repro_torch.launch.serve import setup
    from repro_torch.serve.engine import (ContinuousEngine, Engine,
                                          ServeConfig)
    lib = get_default_library()
    _dev, cfg, params, _ = setup(device, MESH_SERVE["arch"])
    per_step = PROJECTIONS_PER_LAYER * cfg.n_layers
    rng = np.random.default_rng(300)
    policies = serve_load._policy_set(MESH_SERVE["n_requests"])
    reqs = []
    for i in range(MESH_SERVE["n_requests"]):
        prompt = rng.integers(0, cfg.vocab, (int(rng.choice(
            serve_load.PROMPT_LENS)),)).astype(np.int32)
        reqs.append((prompt, ServeConfig(
            max_new_tokens=MESH_SERVE["max_new"],
            temperature=0.0 if i % 2 == 0 else 0.8,
            seed=int(rng.integers(0, 1 << 16)), policy=policies[i])))
    cap = max(serve_load.PROMPT_LENS) + MESH_SERVE["max_new"]
    runs = {}
    for which, sharding in (("unsharded", None), ("sharded", slot_sharding(
            MESH_SERVE["n_slots"], two))):
        eng = ContinuousEngine(
            cfg, params, library=lib, multipliers=serve_load.MULTIPLIERS,
            n_slots=MESH_SERVE["n_slots"], capacity=cap,
            block_size=serve_load.BLOCK_SIZE, variant="pallas",
            sharding=sharding)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        stats = serve_load._drive(eng, reqs, 2.0, seed=400)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        for k, v in launches.items():
            launches_total[k] += v
        fin = eng.scheduler.finished
        runs[which] = (eng, [fin[r].tokens for r in stats["rids"]], wall,
                       launches, stats)
    eng, toks, wall, launches, stats = runs["sharded"]
    _, plain_toks, plain_wall, plain_launches, _ = runs["unsharded"]
    bad = [e for e in eng.step_log
           if e["single"] or e["banked"] != per_step * e.get("shards", 1)
           or e["launches"] != {"lut_matmul_bank":
                                per_step * e.get("shards", 1)}]
    two_shard = sum(1 for e in eng.step_log if e.get("shards") == 2)
    if toks != plain_toks or bad or not two_shard or len(eng.kvs) != 2:
        raise AssertionError(f"sharded engine: tokens equal "
                             f"{toks == plain_toks}, steps off the formula "
                             f"{bad[:2]}, two-shard steps {two_shard}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    replay = [Engine(cfg, params, eng.lane_policy(serve), library=lib)
              .generate(prompt[None], serve)[0].tolist()
              for prompt, serve in reqs]
    replay_s = time.perf_counter() - t0
    replay_launches = {k: v for k, v in ops.launch_counts().items() if v}
    for k, v in replay_launches.items():
        launches_total[k] += v
    if (replay != toks or replay_launches.get("lut_matmul", 0) <= 0
            or "lut_matmul_bank" in replay_launches):
        raise AssertionError(f"sharded engine tokens differ from the "
                             f"sequential replay ({replay_launches})")
    n_tok = sum(len(t) for t in toks)
    log(f"continuous {MESH_SERVE['arch']} full width, "
        f"{MESH_SERVE['n_slots']} slots split 2 + 2: sharded {wall:.3f} s "
        f"({n_tok / wall:.2f} tok/s, {stats['steps']} steps, {two_shard} "
        f"decode steps on both shards), unsharded {plain_wall:.3f} s; "
        f"lut_matmul_bank {per_step} a shard a step; tokens equal the "
        f"unsharded engine's and the replay's ({replay_s:.2f} s)")
    timed["continuous"] = {
        "sharded_s": wall, "unsharded_s": plain_wall, "launches": launches,
        "unsharded_launches": plain_launches, "replay_s": replay_s,
        "tokens": n_tok, "steps": stats["steps"],
        "two_shard_decode_steps": two_shard}
    del runs, eng
    torch.cuda.empty_cache()
    return {"tokens": toks}


def _mesh_psum(device, log, timed: dict) -> dict:
    """``compressed_psum`` over an NCCL group of world size 1 on the
    card, equal bit for bit to its plain formula on the host."""
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.train.compression import compressed_psum
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    gen = torch.Generator(device=device).manual_seed(0)
    tree = {"w": torch.randn((1024, 1024), generator=gen, device=device),
            "b": {"c": torch.randn((4096,), generator=gen, device=device)
                  * 1e-3}}
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        got = compressed_psum(tree)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    wall = time.perf_counter() - t0
    for path, g in (("w", tree["w"]), ("b/c", tree["b"]["c"])):
        g = g.cpu()
        s = torch.clamp_min(torch.max(torch.abs(g)) / 127.0, 1e-12)
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
        want = q.to(torch.int32).to(torch.float32) * s / 1.0
        node = got
        for part in path.split("/"):
            node = node[part]
        if not torch.equal(node.cpu(), want):
            raise AssertionError(f"compressed_psum {path} differs from "
                                 f"its plain formula")
    log(f"compressed_psum over an NCCL group of world size 1: equal to its "
        f"plain formula ({wall:.3f} s with the group's set-up)")
    timed["compressed_psum"] = {"wall_s": wall}
    return {"leaves": 2}


def phase_mesh(device, log, launches_total: dict, hetero: dict) -> dict:
    """Path K: lane sharding (``launch.mesh``) on the card, each path
    sharded against unsharded (docstring, phase 13).  ``hetero``: the
    heterogeneous study's record (its verified assignments)."""
    import torch
    from repro_torch.launch.mesh import sweep_mesh
    t0 = time.perf_counter()
    one = sweep_mesh()
    two = sweep_mesh(devices=[device, device])
    log(f"meshes: sweep_mesh() {[str(d) for d in one.devices]}, two-entry "
        f"{[str(d) for d in two.devices]} (one card listed twice: the "
        f"split, per-shard launches and gather, nothing across cards)")
    timed: dict = {}
    out = {"sweep_mesh": [str(d) for d in one.devices],
           "two_entry": [str(d) for d in two.devices]}
    out["sweeps"] = _mesh_sweeps(device, log, two, one, timed,
                                 launches_total)
    out["verification"] = _mesh_verification(device, log, two, hetero,
                                             timed, launches_total)
    out["cgp"] = _mesh_cgp(device, log, two, timed, launches_total)
    out["serve"] = _mesh_serve(device, log, two, timed, launches_total)
    out["compressed_psum"] = _mesh_psum(device, log, timed)
    out["walls"] = timed
    out["phase_s"] = time.perf_counter() - t0
    log(f"mesh phase {out['phase_s']:.1f} s on {_smi('name,power.limit')}")
    torch.cuda.empty_cache()
    return out


#: the dry run's cells: (arch, shape, K9 launches a layer of a decode
#: probe's forward, or None for a train cell)
DRYRUN_CELLS = (("qwen1.5-0.5b", "train_4k", None),
                ("qwen1.5-0.5b", "decode_32k", 7),
                ("mamba2-780m", "long_500k", 2))


def _dryrun_line(r: dict) -> str:
    rf = r["roofline"]
    return (f"argument {r['memory']['argument_bytes'] / 1e9:.3f} GB, "
            f"{r['flops_per_device']:.4g} flops, collectives "
            f"{r['collectives']['total_bytes'] / 1e9:.4f} GB a device; "
            f"compute {rf['compute_s']:.4g} s, memory {rf['memory_s']:.4g} "
            f"s, collective {rf['collective_s']:.4g} s -> "
            f"{rf['bottleneck']}")


def phase_dryrun(device, log, launches_total: dict) -> dict:
    """Path L: the dry run (docstring, phase 14): the production mesh's
    analysis on the host, then each cell's probes realized on the
    card."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    t0 = time.perf_counter()
    card = _smi("name,power.limit")
    out: dict = {"production": {}, "card": {}}
    for arch, shape, _k9 in DRYRUN_CELLS:
        # the full-depth train trace (16 microbatches) is skipped here;
        # the probes carry the analysis
        r = dryrun.run_cell(arch, shape, lower=_k9 is not None)
        if not r["ok"] or r["collectives"]["total_bytes"] <= 0 \
                or r["roofline"]["collective_s"] <= 0:
            raise AssertionError(f"dry run {arch} x {shape} on the "
                                 f"production mesh: {r}")
        log(f"{arch} x {shape} on {r['mesh']} ({r['n_chips']} fake "
            f"ranks): {_dryrun_line(r)}")
        out["production"][f"{arch}/{shape}"] = r
    host_s = time.perf_counter() - t0
    one = Mesh(("data", "model"), (1, 1), (device,))
    # a decode_32k probe at two layers peaks at ~71 GB in 16 GiB blocks:
    # after the earlier phases the cached segments are too fragmented
    # for it, so this phase allocates from fresh, growable segments
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        out["card"] = _dryrun_on_card(device, log, one, card)
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    launches = ops.launch_counts()
    if launches["lowrank_matmul"] <= 0:
        raise AssertionError("dry run: K9 never ran on the card")
    for k, v in launches.items():
        launches_total[k] += v
    out["launches"] = launches
    out["host_s"] = host_s
    out["phase_s"] = time.perf_counter() - t0
    log(f"dry-run phase {out['phase_s']:.1f} s ({host_s:.1f} s of it the "
        f"production-mesh analysis on the host) on {card}")
    return out


def _dryrun_on_card(device, log, one, card: str) -> dict:
    """Each dry-run cell's probes realized on the one-card mesh ``one``
    (phase 14's gates), the launch counters zeroed before the first."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    out = {}
    ops.reset_launch_counts()
    for arch, shape, k9 in DRYRUN_CELLS:
        logits: dict = {"pallas": {}, "ref": {}}
        r = dryrun.run_cell(arch, shape, mesh=one, lower=False,
                            variant="pallas",
                            probe_outputs=logits["pallas"] if k9 else None)
        if not r["ok"] or r["collectives"]["total_bytes"] != 0:
            raise AssertionError(f"dry run {arch} x {shape} on one card: "
                                 f"{r}")
        rec = {"run": r}
        if k9 is not None:
            dryrun.run_probes(arch, shape, one, "auto", "lowrank",
                              variant="ref", realize=device,
                              probe_outputs=logits["ref"])
            rec["pallas_vs_ref"] = {}
            for p in r["probe_details"]:
                got = p["launches"].get("lowrank_matmul", 0)
                if got != k9 * p["depth"]:
                    raise AssertionError(
                        f"{arch} x {shape} {p['probe']}: K9 launched "
                        f"{got} times, the call sites make "
                        f"{k9 * p['depth']}")
                a = logits["pallas"][p["probe"]].float()
                b = logits["ref"][p["probe"]].float()
                d = float((a - b).abs().max())
                atol = QUANT_RTOL * float(b.abs().max())
                if not (bool(torch.isfinite(a).all()) and d <= atol):
                    raise AssertionError(
                        f"{arch} x {shape} {p['probe']}: pallas logits "
                        f"differ from ref by {d} > {atol}")
                rec["pallas_vs_ref"][p["probe"]] = {"max_abs": d,
                                                    "atol": atol}
        del logits
        for p in r["probe_details"]:
            log(f"{arch} x {shape} {p['probe']} (depth {p['depth']}) on "
                f"{card}: wall {p['wall_s'] * 1e3:.2f} ms, first run "
                f"{p['compile_s']:.2f} s, peak "
                f"{(p['peak_bytes'] or 0) / 1e9:.2f} GB; roofline bound "
                f"{p['bound_s'] * 1e3:.3f} ms ({p['flops']:.4g} flops, "
                f"{p['bytes'] / 1e9:.3f} GB unfused); launches "
                f"{p['launches']}"
                + (f"; pallas vs ref max |d logits| "
                   f"{rec['pallas_vs_ref'][p['probe']]['max_abs']:.4g} "
                   f"(tolerance "
                   f"{rec['pallas_vs_ref'][p['probe']]['atol']:.4g})"
                   if k9 is not None else ""))
        out[f"{arch}/{shape}"] = rec
        torch.cuda.empty_cache()
    return out


def _profile_continuous_step(device) -> dict:
    """One decode step of the continuous engine with 4 active slots (4
    requests at the serve CLI's defaults, 4 tables of the serve-load
    bank, ``pallas``) under ``torch.profiler`` (``_profiled``)."""
    import numpy as np
    from repro_torch.approx.layers import ApproxPolicy
    from repro_torch.approx.specs import BackendSpec
    from repro_torch.core.library import get_default_library
    from repro_torch.launch import serve, serve_load
    from repro_torch.serve import ContinuousEngine, ServeConfig
    mults = serve_load.MULTIPLIERS[::2]
    dev, cfg, params, prompts = serve.setup(
        device, SERVE["arch"], batch=4, prompt_len=SERVE["prompt_len"])
    engine = ContinuousEngine(
        cfg, params, library=get_default_library(),
        multipliers=serve_load.MULTIPLIERS, n_slots=4,
        capacity=SERVE["prompt_len"] + SERVE["max_new"], variant="pallas")
    for row, mult in zip(prompts, mults):
        engine.submit(row, ServeConfig(
            max_new_tokens=SERVE["max_new"], policy=ApproxPolicy(
                default=BackendSpec(mode="lut", multiplier=mult,
                                    ste=False)).to_json()))
    engine.step()                       # 4 prefills + the first step
    engine.step()                       # warm-up decode step
    prof = _profiled(engine.step)
    last = engine.step_log[-1]
    prof.update(lanes=last["lanes"], launches=last["launches"],
                distinct_policies=len(set(mults)))
    if last["kind"] != "decode" or last["lanes"] != 4:
        raise AssertionError(f"profiled continuous step malformed: {last}")
    del engine, params
    return prof


def phase_serve_continuous(device, log, launches_total: dict) -> dict:
    """Path E: continuous-batching mixed-policy serving at the full width
    of qwen1.5-0.5b.  ``launch.serve_load.run(quick=True)`` under
    ``pallas`` (K2) and ``fused`` (K4), each failing unless both of its
    gates hold (every request's tokens equal the sequential
    ``Engine.generate`` replay, which runs K1 (K3); the banked kernel
    launched exactly 7 x 24 times a prefill and a decode step and
    nothing else; one bank build), its decode steps and requests a level
    equal the reference's recorded run, and fused tokens equal pallas
    tokens for every request; then ``launch.serve.run(continuous=True)``
    at the CLI defaults under ``pallas``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, serve_load
    cfg = get_config(SERVE["arch"])
    per_step = PROJECTIONS_PER_LAYER * cfg.n_layers
    with open(BENCH_SERVE) as f:
        bench = json.load(f)
    want_levels = [(lv["n_policies"], lv["n_requests"], lv["decode_steps"])
                   for lv in bench["levels"]]
    out, tokens = {}, {}
    for variant, kernels in CONTINUOUS_KERNELS.items():
        record, wall, launches = _drive(
            f"serve_load --quick ({variant})",
            lambda: serve_load.run(device, quick=True, variant=variant,
                                   log=log), kernels)
        got_levels = [(lv["n_policies"], lv["n_requests"],
                       lv["decode_steps"]) for lv in record["levels"]]
        if (got_levels != want_levels
                or record["banked_per_step_expected"] != per_step
                or not record["bit_identity"]
                or not record["banked_per_step_gate"]):
            raise AssertionError(
                f"serve_load ({variant}): levels {got_levels} (recorded "
                f"{want_levels}), gates {record['bit_identity']} / "
                f"{record['banked_per_step_gate']}")
        log(f"serve_load ({variant}): decode steps {got_levels} equal the "
            f"recorded run; {record['bit_identity_requests']} requests "
            f"equal the sequential replay; {kernels[0]} {per_step} a "
            f"prefill and a decode step ({record['steps']})")
        tokens[variant] = record["tokens"]
        for k, v in launches.items():
            launches_total[k] += v
        out[f"serve_load_{variant}"] = {**record, "main_path_s": wall,
                                        "launches": launches}
    if tokens["fused"] != tokens["pallas"]:
        raise AssertionError("serve_load: fused tokens differ from pallas")
    log(f"serve_load: fused tokens equal pallas for all "
        f"{len(tokens['pallas'])} requests")
    record, wall, launches = _drive(
        "serve --continuous qwen1.5-0.5b (pallas)",
        lambda: serve.run(device, arch=SERVE["arch"], batch=SERVE["batch"],
                          prompt_len=SERVE["prompt_len"],
                          max_new=SERVE["max_new"], variant="pallas",
                          continuous=True, log=log), ("lut_matmul_bank",))
    toks = np.asarray(list(record["tokens"].values()))
    k2 = {"lut_matmul_bank": per_step}
    if (toks.shape != (SERVE["batch"], SERVE["max_new"])
            or toks.min() < 0 or toks.max() >= cfg.vocab
            or record["bank_builds"] != 1
            or record["steps"]["decode"]["launches"] != [k2]
            or record["steps"]["prefill"]["launches"] != [k2]):
        raise AssertionError(f"serve --continuous malformed: tokens "
                             f"{toks.shape}, {record['steps']}")
    for k, v in launches.items():
        launches_total[k] += v
    out["serve_continuous"] = {**record, "main_path_s": wall,
                               "launches": launches}
    torch.cuda.empty_cache()
    return out


def phase_profile_continuous(device) -> dict:
    """One continuous decode step profiled (``_profile_continuous_step``);
    the host's ``cudaLaunchKernel`` calls in the window are printed
    beside the device-side kernels it recorded."""
    prof = _profile_continuous_step(device)
    launches = sum(e["calls"] for e in prof["top_host"]
                   if e["name"] == "cudaLaunchKernel")
    print(f"[profile] continuous: one decode step (4 slots, "
          f"{prof['distinct_policies']} policies) {prof['wall_ms']:.2f} ms "
          f"under the profiler, device busy {prof['device_busy_ms']} ms "
          f"(share {prof['busy_share']}, {prof['kernels']} kernels, "
          f"{launches} cudaLaunchKernel calls, counted launches "
          f"{prof['launches']}); top device {prof['top'][:5]}; top host "
          f"{prof['top_host'][:5]}")
    return prof


def _profile_rows(prof) -> list:
    return [(r.module, r.multiplier, r.metrics, r.network_rel_power)
            for r in prof.rows]


def _check_quick_profiles(record, bench, variant: str, log) -> None:
    """``arch_profiles --quick``: its four gates hold, and what does not
    depend on the weights equals the reference's recorded run: the five
    archs, each one's modules (in order), module shares (exactly) and
    row count, and the multipliers; the selections are printed beside
    the record's."""
    failed = [g for g, ok in record["gates"].items() if not ok]
    if failed:
        raise AssertionError(f"arch_profiles --quick ({variant}): gates "
                             f"failed {failed}")
    archs, want = list(record["zoo"]["archs"]), list(bench["zoo"]["archs"])
    if archs != want:
        raise AssertionError(f"profiled archs {archs} != recorded {want}")
    if record["multipliers"] != bench["multipliers"]:
        raise AssertionError(f"profile multipliers {record['multipliers']} "
                             f"!= recorded {bench['multipliers']}")
    for arch, got in record["zoo"]["archs"].items():
        want = bench["zoo"]["archs"][arch]
        if (got["modules"] != want["modules"]
                or got["module_shares"] != want["module_shares"]
                or len(got["rows"]) != len(want["rows"])):
            raise AssertionError(f"{arch} ({variant}): modules, shares or "
                                 "row count differ from the recorded run")
        sel, rsel = got["selected"], want["selected"]
        st = record["stats"][arch]
        log(f"profiles {arch} ({variant}): stages "
            f"{ {k: round(st[k], 4) for k in PROFILE_STAGES} }, banked "
            f"launches {st['banked_calls']}, peak memory "
            f"{st.get('peak_bytes', 0) / 2**30:.3f} GiB")
        log(f"profiles {arch} ({variant}): modules, shares and "
            f"{len(got['rows'])} rows equal the record; selected "
            f"{sel['modules']} power {sel['power']:.4f} drop "
            f"{sel['quality_drop']:.4f} (record: {rsel['modules']} power "
            f"{rsel['power']:.4f} drop {rsel['quality_drop']:.4f})")


def _full_width_profile(cfg, family: str, variant: str, lib, mults,
                        device, log) -> dict:
    """One config at full width under one variant: the profile (stage
    walls, banked calls, peak memory, selection) and the identity check
    over every row (banked sweep vs sequential ``policy_for_lane``
    evaluation bit for bit; the banked kernel launched exactly the
    formula's count in the banked sweep, and nothing else)."""
    import torch
    from repro_torch.approx.dse import verify_assignments
    from repro_torch.approx.modules import (FILL_EXACT,
                                            module_sweep_assignments)
    from repro_torch.launch import arch_profiles
    from repro_torch.kernels import ops
    kernel = DSE_KERNEL[variant]
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    prof, st, wl, mmap = arch_profiles.profile_config(
        cfg, family, lib, mults, variant=variant, device=device)
    before = ops.launch_counts()
    ident = arch_profiles.identity_check(wl, mmap, lib, mults, cfg,
                                         variant)
    after = ops.launch_counts()
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device)
    expected = ident["banked_calls_expected"]
    enc = f"{cfg.n_enc_layers} + " if cfg.n_enc_layers else ""
    label = f"{cfg.name} ({enc}{cfg.n_layers} layers, {variant})"
    if not (ident["bit_identical"]
            and ident["banked_calls_full"] == expected
            and ident["banked_calls_truncated"] == expected
            and prof.selected is not None
            and prof.selected["quality_drop"] <= prof.max_drop + 1e-9):
        raise AssertionError(f"{label}: identity {ident['bit_identical']} "
                             f"({ident['mismatches']}), banked calls "
                             f"{ident['banked_calls_full']} / "
                             f"{ident['banked_calls_truncated']} != "
                             f"{expected}, selected {prof.selected}")
    spent = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    # the banked sweep, its 2-row truncation: K2 (K4) each; the
    # sequential evaluations: K1 (K3) only
    if spent.get(kernel) != 2 * expected or set(spent) - {
            kernel, PROFILE_SINGLE[variant]}:
        raise AssertionError(f"{label}: launches {spent}, expected "
                             f"{2 * expected} {kernel} and the sequential "
                             f"{PROFILE_SINGLE[variant]}")
    walls = {k: st[k] for k in PROFILE_STAGES}
    # one banked sweep of every row under the profiler: device busy and
    # the kernels it ran
    grid = module_sweep_assignments(mmap, mults)
    lowered = [mmap.lower(a) for _f, _m, a in grid]
    prof_sweep = _profiled(lambda: verify_assignments(
        wl, lowered, mmap.layer_counts, lib, layers=mmap.layers,
        fill=FILL_EXACT, variant=variant))
    log(f"profile {label}: one banked sweep under the profiler "
        f"{prof_sweep['wall_ms']:.1f} ms, device busy "
        f"{prof_sweep['device_busy_ms']} ms (share "
        f"{prof_sweep['busy_share']}, {prof_sweep['kernels']} kernels); "
        f"top device {prof_sweep['top'][:3]}")
    log(f"profile {label}: stages {walls}; banked launches a sweep "
        f"{expected} ({kernel}, {len(prof.rows)} rows; the profile made "
        f"{st['banked_calls']}); identity banked {ident['banked_s']:.3f} s "
        f"vs sequential {ident['sequential_s']:.3f} s over "
        f"{ident['rows']} rows, bit for bit; peak memory "
        f"{peak / 2**30:.2f} GiB; selected {prof.selected['modules']} "
        f"power {prof.selected['power']:.4f} drop "
        f"{prof.selected['quality_drop']:.4g}")
    return {"profile": prof.to_dict(), "walls": walls,
            "banked_calls_profile": st["banked_calls"],
            "banked_launches_sweep": expected, "launches_identity": spent,
            "identity": {k: v for k, v in ident.items() if k != "metrics"},
            "peak_bytes": peak, "sweep_profile": prof_sweep,
            "rows": _profile_rows(prof),
            "identity_metrics": ident["metrics"]}


def _profile_step_timing(device) -> list:
    """K2 and K4 at the profile sweeps' full-width shapes (``PROFILE_STEP``,
    banked activations): ms a launch (CUDA events) beside its bound, the
    largest of the lookups, the integer ops and the bytes (the int32 or
    f32 operands once, P tables, the outputs)."""
    import torch
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops
    gen = torch.Generator(device=device).manual_seed(2)
    t = _tables(device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    lookup_rate = sms * LOOKUPS_PER_SM_CLOCK * clock_hz
    int_rate = sms * INT32_OPS_PER_SM_CLOCK * clock_hz
    rows = []
    steps = [(*shape, 20, 3) for shape in PROFILE_STEP] + [
        (*shape, 3, 1) for shape in PROFILE_STEP_LARGE]
    for p_, m, k, n, reps, warmup in steps:
        idx = torch.arange(p_, device=device) % t["profile"].shape[0]
        luts = t["profile"].index_select(0, idx)
        qab, qw = _codes((p_, m, k), gen, device), _codes((k, n), gen, device)
        xb, w = _floats((p_, m, k), gen, device), _floats((k, n), gen,
                                                          device, 0.2)
        sp = _scalars(xb, w, 8)
        products = p_ * m * k * n
        tables_b = p_ * 65536 * 2
        for kernel, call, extra_b in (
                ("lut_matmul_bank",
                 lambda: ops.approx_matmul_lut_bank(qab, qw, luts), 0),
                ("fused_matmul_bank",
                 lambda: ops.fused_matmul_lut_bank(xb, w, luts, *sp,
                                                   raw=True),
                 p_ * (m + n) * 4)):
            nbytes = (p_ * m * k + k * n + p_ * m * n) * 4 + tables_b \
                + extra_b
            rows.append({"kernel": kernel, "lanes": p_, "M": m, "K": k,
                         "N": n, "ms": _time(call, reps=reps,
                                             warmup=warmup),
                         "items": fm.k_split(
                             p_, m, k, n, sms,
                             quant8=kernel == "fused_matmul_bank").items,
                         **_bounds(products / lookup_rate,
                                   int_seconds(0, 2 * products, int_rate),
                                   nbytes / HBM_BYTES_PER_S)})
        del qab, qw, xb, w
    for r in rows:
        print(f"[main] profile step {r['kernel']} P={r['lanes']} "
              f"{(r['M'], r['K'], r['N'])}: {r['ms']:.4f} ms a launch, "
              f"bound {r['bound_ms']:.4f} ms ({r['limit']})")
    return rows


def phase_profiles(device, log, launches_total: dict) -> dict:
    """Path F: the module-resilience profiles of the LM zoo.  (a)
    ``launch.arch_profiles.run(quick=True)`` under ``pallas`` (K2, K1)
    and ``fused`` (K4, K3): the four gates, and the record's
    weight-independent fields against ``BENCH_profiles.json`` for all
    five archs; (b) ``run(quick=False)`` under ``pallas``: the eight
    reduced archs and ResNet-8, the four gates; (c) at full width
    (``PROFILE_FULL_WIDTH``: mamba2-780m; qwen3-moe-30b-a3b with 2 of its
    48 layers; whisper-large-v3 with 4 + 4 of its 32 + 32 layers and all
    1 500 frames; deepseek-v2-236b with 1 of its 60 layers), the configs'
    dtype, random weights on the card: each profile's walls, banked
    launches, peak memory and selection, banked == sequential on every
    row, the launch count, and fused rows == pallas rows; (d) K2 and K4
    timed at those sweeps' shapes."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.library import get_default_library
    from repro_torch.launch import arch_profiles
    from repro_torch.models.registry import abstract_params
    with open(BENCH_PROFILES) as f:
        bench = json.load(f)
    out, rows = {}, {}
    for variant in ("pallas", "fused"):
        torch.cuda.reset_peak_memory_stats(device)
        record, wall, launches = _drive(
            f"arch_profiles --quick ({variant})",
            lambda: arch_profiles.run(device, quick=True, variant=variant,
                                      log=log),
            (DSE_KERNEL[variant], PROFILE_SINGLE[variant]))
        _check_quick_profiles(record, bench, variant, log)
        rows[("quick", variant)] = {a: [(r["module"], r["multiplier"],
                                         r["metrics"])
                                        for r in p["rows"]]
                                    for a, p in record["zoo"]["archs"]
                                    .items()}
        for k, v in launches.items():
            launches_total[k] += v
        out[f"quick_{variant}"] = {
            **record, "main_path_s": wall, "launches": launches,
            "peak_bytes": torch.cuda.max_memory_allocated(device)}
    if rows[("quick", "fused")] != rows[("quick", "pallas")]:
        raise AssertionError("arch_profiles --quick: fused rows differ "
                             "from pallas")
    log("profiles --quick: fused rows equal pallas rows, metric for metric")

    # full mode: the eight reduced archs (llava-next-34b's vlm path among
    # them) and ResNet-8; a failed gate raises
    torch.cuda.reset_peak_memory_stats(device)
    record, wall, launches = _drive(
        "arch_profiles full (pallas)",
        lambda: arch_profiles.run(device, quick=False, variant="pallas",
                                  log=log),
        (DSE_KERNEL["pallas"], PROFILE_SINGLE["pallas"]))
    for k, v in launches.items():
        launches_total[k] += v
    archs = list(record["zoo"]["archs"])
    expected = [a for a, _f in arch_profiles.QUICK_ARCHS
                + arch_profiles.FULL_EXTRA_ARCHS] + ["resnet8-cifar"]
    if archs != expected:
        raise AssertionError(f"arch_profiles full profiled {archs}, "
                             f"expected {expected}")
    log(f"profiles full (pallas): {len(archs)} profiles in {wall:.2f} s, "
        f"gates {record['gates']}, multipliers {record['multipliers']}")
    out["full_pallas"] = {**record, "main_path_s": wall,
                          "launches": launches,
                          "peak_bytes": torch.cuda.max_memory_allocated(
                              device)}

    lib = get_default_library()
    mults = arch_profiles._multipliers(lib, quick=True)
    for arch, family, cuts in PROFILE_FULL_WIDTH:
        cfg = get_config(arch)
        reduced = {k: f"{v} of {getattr(cfg, k)}" for k, v in cuts.items()}
        cfg = dataclasses.replace(cfg, **cuts)
        n_params = sum(v.numel() for v in _leaves(abstract_params(cfg)))
        log(f"profile {arch} at full width (d_model {cfg.d_model}, "
            f"{cfg.n_layers} layers, {cfg.dtype}): {n_params / 1e9:.3f} B "
            f"f32 parameters, {n_params * 4 / 1e9:.2f} GB"
            + (f"; reduced {reduced}" if reduced else ""))
        got = {}
        for variant in ("pallas", "fused"):
            record, wall, launches = _drive(
                f"profile {arch} at full width ({variant})",
                lambda: _full_width_profile(cfg, family, variant, lib,
                                            mults, device, log),
                (DSE_KERNEL[variant], PROFILE_SINGLE[variant]))
            got[variant] = {**record, "main_path_s": wall,
                            "launches": launches}
            for k, v in launches.items():
                launches_total[k] += v
            torch.cuda.empty_cache()
        if (got["fused"]["rows"] != got["pallas"]["rows"]
                or got["fused"]["identity_metrics"]
                != got["pallas"]["identity_metrics"]):
            raise AssertionError(f"{arch} at full width: fused rows differ "
                                 "from pallas")
        log(f"profile {arch} at full width: fused rows equal pallas rows")
        for v in got.values():
            v.pop("rows")
            v.pop("identity_metrics")
        out[f"full_{arch}"] = {"n_layers": cfg.n_layers,
                               "n_enc_layers": cfg.n_enc_layers,
                               "params": n_params, "reduced": reduced,
                               **got}
    torch.cuda.empty_cache()
    out["step_timing"] = _profile_step_timing(device)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif hasattr(tree, "numel"):
        yield tree


def _expert_operands(p_, e, m, k, n, gen, device, blocks: int = 1) -> dict:
    """The expert form's operands at one shape: codes (K1/K2) and floats
    (K3/K4) of ``blocks`` x E slices, banked (P lanes) and shared, the
    stacked weights, and each (lane, slice) pair's scalars (the backend's
    ``calibrate_slices``, weight scalars per expert)."""
    from repro_torch.approx.quant import calibrate_slices, pair_scalars
    x_ = blocks * e
    out = {"qab": _codes((p_, x_, m, k), gen, device),
           "qa": _codes((x_, m, k), gen, device),
           "qw": _codes((e, k, n), gen, device),
           "xb": _floats((p_, x_, m, k), gen, device),
           "x": _floats((x_, m, k), gen, device),
           "w": _floats((e, k, n), gen, device, 0.2)}
    qp_w = calibrate_slices(out["w"])
    for key in ("xb", "x"):
        out[f"sp_{key}"] = pair_scalars(calibrate_slices(out[key]), qp_w,
                                        p_, x_)
    return out


def _experts_lowrank(device, gen, max_err: dict, fp32_rate: float) -> tuple:
    """K9's expert form (qa (X,C,K) against qw (E,K,N), the served
    multiplier's rank-4 factors): (a) at ``LOWRANK_EXPERT_CHECK`` and
    ``LOWRANK_EXPERT_RAGGED`` every slice within the bound of the plain
    version (``ref.lowrank_matmul_experts_ref``), a second call bit-equal;
    (b) at ``LOWRANK_EXPERT_FULL`` against E launches of K9 without the
    axis, both within the bound, each timed (CUDA events) beside the
    bound: the codes, tables and outputs moved once at 3.35 TB/s and the
    flops at the faster f32-accurate rate (``_lowrank_timing``'s).
    Returns (cases, rows)."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lowrank_matmul import plan
    _, factors = _served_factors(device)
    u, v = factors["R=4"]
    r = u.shape[0]
    cases, rows = [], []
    shapes = [(c, 1) for c in LOWRANK_EXPERT_CHECK] + [
        (c, EXPERT_BLOCKS if i == len(LOWRANK_EXPERT_RAGGED) - 1 else 1)
        for i, c in enumerate(LOWRANK_EXPERT_RAGGED)]
    for (e, m, k, n), blocks in shapes:
        what = f"E={e} x{blocks} {(m, k, n)}"
        qa = _codes((blocks * e, m, k), gen, device)
        qw = _codes((e, k, n), gen, device)
        got = ops.lowrank_matmul(qa, qw, u, v)
        err, ratio, worst = _check_lowrank(
            got, ref.lowrank_matmul_experts_ref(qa, qw, u, v), qa, qw, u, v,
            f"expert form {what}")
        again = ops.lowrank_matmul(qa, qw, u, v)
        torch.cuda.synchronize()
        if not torch.equal(again, got):
            raise AssertionError(f"lowrank_matmul expert form {what}: a "
                                 "second call differs")
        max_err["lowrank_matmul"] = max(max_err["lowrank_matmul"], err)
        p = plan(m, k, n, r, blocks * e)
        cases.append({"E": e, "X": blocks * e, "M": m, "K": k, "N": n,
                      "regime": p.regime, "splits": p.splits,
                      "workspace_bytes": p.workspace_bytes,
                      "max_abs_err": err, "err_over_bound": ratio, **worst})
        del qa, qw, got, again
    print(f"[experts] K9 expert form: {len(cases)} cases within the bound "
          f"of the plain version, per slice (max |K9 - y64| / bound "
          f"{max(c['err_over_bound'] for c in cases):.3g}); " + json.dumps(
              cases))
    for e, m, k, n in LOWRANK_EXPERT_FULL:
        what = f"E={e} {(m, k, n)}"
        qa = _codes((e, m, k), gen, device)
        qw = _codes((e, k, n), gen, device)

        def call():
            return ops.lowrank_matmul(qa, qw, u, v)

        def loop():
            return [ops.lowrank_matmul(qa[j], qw[j], u, v)
                    for j in range(e)]
        diff, ratio, _ = _check_lowrank(call(), torch.stack(loop()), qa, qw,
                                        u, v, f"expert form {what} and its "
                                        f"{e} launches")
        ms = _time(call, reps=3, warmup=1)
        loop_ms = _time(loop, reps=2, warmup=1)
        flops = 2 * e * m * k * n * r
        nbytes = (qa.numel() + qw.numel() + 2 * r * 256 + e * m * n) * 4
        ops_ms = min(flops / fp32_rate, TF32_SPLIT_PRODUCTS * flops
                     / TF32_FLOPS_PER_S) * 1e3
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        p = plan(m, k, n, r, e)
        rows.append({"kernel": "lowrank_matmul", "form": "experts",
                     "experts": e, "M": m, "K": k, "N": n, "R": r,
                     "regime": p.regime, "blocks": p.blocks,
                     "splits": p.splits,
                     "workspace_bytes": p.workspace_bytes, "ms": ms,
                     "e_launches_ms": loop_ms,
                     "max_abs_diff_e_launches": diff,
                     "err_over_bound": ratio, "ops_ms": ops_ms,
                     "bytes_ms": bytes_ms,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms
                     else "bytes"})
        print(f"[experts] lowrank_matmul {what} ({p.regime}, {p.blocks} "
              f"blocks, {p.splits} K slices, workspace "
              f"{p.workspace_bytes / 1e6:.1f} MB): one launch {ms:.3f} ms, "
              f"{e} launches without the axis {loop_ms:.3f} ms, bound "
              f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); "
              f"both within the bound (max |K9 - y64| / bound "
              f"{ratio:.3g}), "
              f"max |one launch - {e} launches| {diff:.3g}")
        del qa, qw
        torch.cuda.empty_cache()
    return cases, rows


def _experts_composed(device, gen, t: dict, check, rates: tuple) -> list:
    """K5-K8's expert form at ``COMPOSED_EXPERT``: K5/K7 on a 12-bit entry
    of the wide study's bank, K6/K8 on its 8-, 12- and 16-bit lanes (one
    tree), K8 on the mixed-reduce bank, each operand quantized at its
    lane's width per (lane, slice) pair (``calibrate_slices``), as the
    datapath does; each held bit for bit (``check``) against its plain
    version (``ref.*_experts_ref``) and against E launches without the
    axis (the fused kernels' raw outputs and f32 results), and each timed
    with its E launches beside its bound (lookups, integer ops, bytes:
    ``phase_timing``'s).  Returns the timing rows."""
    import torch
    from repro_torch.approx.quant import (calibrate_slices, pair_scalars,
                                          quantize)
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops, ref
    lookup_rate, int_rate = rates
    e, m, k, n = COMPOSED_EXPERT
    wide = t["wide"]
    widths = wide["bits"].tolist()
    sel = torch.tensor([widths.index(b) for b in (8, 12, 16)],
                       device=device)
    three = {key: v.index_select(0, sel) for key, v in wide.items()}
    i12 = widths.index(12)
    one = {key: v[i12:i12 + 1] for key, v in wide.items()}
    x = _floats((e, m, k), gen, device)
    w = _floats((e, k, n), gen, device, 0.2)
    red = ("loa", 4)                       # the wide study's tree
    rows = []

    def per_pair(bank, kind: str, pairs: int, nbytes: int):
        """Lookups, integer ops and bytes of ``pairs`` (lane, slice) pairs
        of ``bank``'s lanes, lane-major."""
        lanes = bank["masks"].shape[0]
        lookups = logic = arith = 0
        for mask, (kd, kk) in zip(bank["masks"].tolist(),
                                  bank["codes"].tolist()):
            lo_, ar_ = int_ops_per_product(mask, kd, kk)
            each = pairs // lanes * m * k * n
            lookups += (4 if mask else 1) * each
            logic, arith = logic + lo_ * each, arith + ar_ * each
        return _bounds(lookups / lookup_rate,
                       int_seconds(logic, arith, int_rate),
                       nbytes / HBM_BYTES_PER_S)

    def timed(kernel, what, call, loop, bounds):
        ms = _time(call, reps=3, warmup=1)
        loop_ms = _time(loop, reps=3, warmup=1)
        rows.append({"kernel": kernel, "form": "experts", "case": what,
                     "experts": e, "M": m, "K": k, "N": n, "ms": ms,
                     "e_launches_ms": loop_ms, **bounds})
        print(f"[experts] {kernel} {what} E={e} {(m, k, n)}: one launch "
              f"{ms:.3f} ms, {e} launches without the axis {loop_ms:.3f} "
              f"ms, bound {bounds['bound_ms']:.4f} ms ({bounds['limit']}); "
              f"equal bit for bit to the plain version and the launches")

    # K5 and K6 on codes
    for kernel, bank in (("composed_matmul", one),
                         ("composed_matmul_bank", three)):
        bits = 12 if kernel == "composed_matmul" else bank["bits"]
        qa = quantize(x, calibrate_slices(x, bits))
        qw = quantize(w, calibrate_slices(w, bits))
        tab, masks, codes = bank["luts"], bank["masks"], bank["codes"]
        if kernel == "composed_matmul":
            mask = int(masks[0])

            def call():
                return ops.composed_matmul_lut(qa, qw, tab[0], mask, red,
                                               raw=True)

            def loop():
                per = [ops.composed_matmul_lut(qa[s], qw[s], tab[0], mask,
                                               red, raw=True)
                       for s in range(e)]
                return [torch.stack(v) for v in zip(*per)]
            plain = ref.composed_matmul_limbs_experts_ref(
                qa, qw, tab[0].to(torch.int32), masks, codes)
            pairs = e
        else:
            def call():
                return ops.composed_matmul_lut_bank(qa, qw, tab, masks, red,
                                                    raw=True, experts=True)

            def loop():
                per = [ops.composed_matmul_lut_bank(
                    qa[:, s].contiguous(), qw[:, s].contiguous(), tab,
                    masks, red, raw=True) for s in range(e)]
                return [torch.stack(v, dim=1) for v in zip(*per)]
            plain = ref.composed_matmul_bank_experts_ref(
                qa, qw, tab.to(torch.int32), masks, codes)
            pairs = e * masks.shape[0]
        what = f"{kernel} {tuple(qa.shape)} x {tuple(qw.shape)}"
        check(kernel, call(), plain, f"plain {what}")
        check(kernel, call(), loop(), f"{e} launches, {what}")
        timed(kernel, "12-bit entry" if pairs == e else "8/12/16 bank",
              call, loop, per_pair(bank, kernel, pairs,
                                   (qa.numel() + qw.numel()) * 4
                                   + masks.shape[0] * 65536 * 2
                                   + 2 * pairs * m * n * 4))
        del qa, qw, plain
    # K7 and K8 on floats: one table, the 8/12/16 bank, the mixed-reduce
    # bank (shared and banked activations against the plain version)
    xb = _floats((t["mixed"]["luts"].shape[0], e, m, k), gen, device)
    for kernel, bank, label in (
            ("fused_composed_matmul", one, "12-bit entry"),
            ("fused_composed_matmul_bank", three, "8/12/16 bank"),
            ("fused_composed_matmul_bank", t["mixed"], "mixed-reduce bank")):
        banked = kernel.endswith("_bank")
        lanes = bank["luts"].shape[0]
        bits = bank["bits"] if banked else 12
        op = (ops.fused_composed_matmul_lut_bank if banked
              else ops.fused_composed_matmul_lut)
        plain_fn = (ref.fused_composed_matmul_bank_experts_ref if banked
                    else ref.fused_composed_matmul_experts_ref)
        tab = bank["luts"] if banked else bank["luts"][0]
        masks, codes = bank["masks"], bank["codes"]
        for xin in ((xb, x) if label == "mixed-reduce bank" else (x,)):
            sp = pair_scalars(calibrate_slices(xin, bits),
                              calibrate_slices(w, bits), lanes, e)
            fp, ip = fm.pack_scalars(lanes * e, device, *sp)
            what = f"{kernel} {label} x{tuple(xin.shape)}"
            want = plain_fn(xin, w, tab.to(torch.int32), masks, codes, fp,
                            ip)
            check(kernel, op(xin, w, tab, masks, codes, *sp, raw=True),
                  want, f"plain {what}")
        # the shared activations' scalars (sp): slice s's pairs l e + s
        at = [torch.arange(lanes, device=device) * e + s for s in range(e)]

        def call(raw=True):
            return op(x, w, tab, masks, codes, *sp, raw=raw)

        def loop(raw=True):
            dim = 1 if banked else 0
            per = [op(x[s], w[s], tab, masks, codes,
                      *[v[at[s]] if isinstance(v, torch.Tensor) else v
                        for v in sp], raw=raw) for s in range(e)]
            if raw:
                return [torch.stack(v, dim=dim) for v in zip(*per)]
            return [torch.stack(per, dim=dim)]
        check(kernel, call(), loop(), f"{e} launches, {what}")
        check(kernel, [call(False)], loop(False), f"{e} launches f32, {what}")
        timed(kernel, label, call, loop, per_pair(
            bank, kernel, lanes * e,
            (x.numel() + w.numel()) * 4 + lanes * 65536 * 2
            + lanes * e * (2 * m * n + m + n) * 4))
    return rows


def phase_experts_cell(device, shapes=EXPERT_CELL) -> list:
    """K4's expert form at ``shapes`` (``EXPERT_CELL``: the 8 lanes' 128
    experts' capacity buffers of the qwen3-moe cell; (lanes, experts, C,
    K, N) each) in one launch (banked activations, each pair's scalars),
    timed (CUDA events, 1 warm-up, 3 calls) beside its bound, its tile
    (``fused_matmul.quant8_tile``) and the share of the slots its tiles
    gather that are padding; the first and the last (lane, expert) pair
    held bit for bit to the plain version."""
    import torch
    from repro_torch.approx.quant import calibrate_slices, pair_scalars
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(35)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    lookup_rate = sms * LOOKUPS_PER_SM_CLOCK * clock_hz
    tables = torch.randint(0, 1 << 16, (max(s[0] for s in shapes), 256,
                                        256), generator=gen,
                           dtype=torch.int32, device=device)
    rows = []
    for p_, e, m, k, n in shapes:
        what = f"P={p_} E={e} C={m} {(k, n)}"
        tabs = tables[:p_]
        x = _floats((p_, e, m, k), gen, device)
        w = _floats((e, k, n), gen, device, 0.05)
        sp = pair_scalars(calibrate_slices(x), calibrate_slices(w), p_, e)
        luts16 = tabs.to(torch.uint16)
        got = ops.fused_matmul_lut_bank(x, w, luts16, *sp, raw=True)
        for lane, ex in ((0, 0), (p_ - 1, e - 1)):
            pair = lane * e + ex
            one = [v.reshape(-1)[pair:pair + 1] if isinstance(
                v, torch.Tensor) and v.numel() > 1 else v for v in sp]
            want = ref.fused_matmul_ref(
                x[lane, ex].contiguous(), w[ex].contiguous(), tabs[lane],
                *fm.pack_scalars(1, device, *one))
            for g_, v_ in zip(got, want):
                if not torch.equal(g_[lane, ex], v_.reshape(
                        g_[lane, ex].shape)):
                    raise AssertionError(f"fused_matmul_bank expert form "
                                         f"!= plain at {what}, pair "
                                         f"{(lane, ex)}")
        del got
        ms = _time(lambda: ops.fused_matmul_lut_bank(x, w, luts16, *sp,
                                                     raw=True),
                   reps=3, warmup=1)
        products = p_ * e * m * k * n
        tile = fm.quant8_tile(m, n)
        rows.append({"kernel": "fused_matmul_bank", "form": "experts",
                     "cell": "qwen3moe.ppl_fused", "lanes": p_,
                     "experts": e, "M": m, "K": k, "N": n, "ms": ms,
                     "tile": [tile.tm, tile.tile_n],
                     "pad_share": 1 - m * n / tile.slots(m, n),
                     "bound_ms": products / lookup_rate * 1e3})
        print(f"[experts] fused_matmul_bank {what}: one launch {ms:.3f} ms "
              f"at a {tile.tm} x {tile.tile_n} tile (padded share "
              f"{rows[-1]['pad_share']:.3f}), lookup bound "
              f"{rows[-1]['bound_ms']:.3f} ms; two pairs equal the plain "
              f"version bit for bit", flush=True)
        del x, w
        torch.cuda.empty_cache()
    return rows


def phase_experts(device) -> dict:
    """The expert axis of K1-K9 (``kernels.ops`` with stacked weights
    (E, K, N): one launch for every expert and bank lane, as
    ``models.moe._expert_matmul`` makes one a projection).  (a) Bit
    for bit against the plain versions (``ref.*_experts_ref``: a loop
    over the pairs of the kernels' plain versions) at ``EXPERT_CHECK`` and
    ``EXPERT_RAGGED``: K1/K3 on one table, K2/K4 on P tables with banked
    and shared activations, the fused kernels' f32 results after the
    eager epilogue too.  (b) At ``EXPERT_FULL`` against E launches of
    K2/K4 without the axis, bit for bit, each form timed (CUDA events)
    beside its bound (the largest of the table lookups at 32 a clock per
    SM, the integer adds and the bytes, ``phase_timing``'s rates).  (c)
    K5-K8 at ``COMPOSED_EXPERT`` (``_experts_composed``) and K9 at its
    shapes (``_experts_lowrank``)."""
    import torch
    from repro_torch.approx.quant import calibrate_slices, pair_scalars
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops, ref
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(3)
    tables = _tables(device)
    profile = tables["profile"]
    max_err = {k: 0.0 for k in (
        "lut_matmul", "lut_matmul_bank", "fused_matmul", "fused_matmul_bank",
        "composed_matmul", "composed_matmul_bank", "fused_composed_matmul",
        "fused_composed_matmul_bank", "lowrank_matmul")}
    cases = 0

    def check(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        for g, v in zip(got, want):
            v = v.reshape(g.shape)
            if g.numel():
                err = float((g.double() - v.double()).abs().max())
                max_err[name] = max(max_err[name], err)
            if not torch.equal(g, v):
                raise AssertionError(f"{name} expert form != {what} (max "
                                     f"abs err {max_err[name]})")
        cases += 1

    def fused(name, op, plain, x, w, tabs, sp, what):
        pairs = (tabs.shape[0] if tabs.ndim == 3 else 1) * x.shape[-3]
        fp, ip = fm.pack_scalars(pairs, device, *sp)
        want = plain(x, w, tabs.to(torch.int32), fp, ip)
        check(name, op(x, w, tabs, *sp, raw=True), want, f"plain {what}")
        k = x.shape[-1]
        lead = want[0].shape[:-2]
        s = want[0].to(torch.float32).reshape(-1, *want[0].shape[-2:])
        f32 = fm.dequant(s, want[1].reshape(-1, want[1].shape[-1]),
                         want[2].reshape(-1, want[2].shape[-1]), fp, ip, k)
        check(name, [op(x, w, tabs, *sp)], [f32.reshape(*lead, *f32.shape[
            -2:])], f"plain {what} f32")

    shapes = [(c, 1) for c in EXPERT_CHECK] + [
        (c, EXPERT_BLOCKS if i == len(EXPERT_RAGGED) - 1 else 1)
        for i, c in enumerate(EXPERT_RAGGED)]
    for (p_, e, m, k, n), blocks in shapes:
        what = f"P={p_} E={e} x{blocks} {(m, k, n)}"
        o = _expert_operands(p_, e, m, k, n, gen, device, blocks)
        idx = torch.arange(p_, device=device) % profile.shape[0]
        tabs = profile.index_select(0, idx)
        if p_ == 1:                       # one table: K1 and K3
            check("lut_matmul", [ops.approx_matmul_lut(o["qa"], o["qw"],
                                                       tabs[0])],
                  [ref.approx_matmul_lut_experts_ref(
                      o["qa"], o["qw"], tabs[0].to(torch.int32))],
                  f"plain {what}")
            fused("fused_matmul", ops.fused_matmul_lut,
                  ref.fused_matmul_experts_ref, o["x"], o["w"], tabs[0],
                  o["sp_x"], what)
        for key in ("qab", "qa"):
            check("lut_matmul_bank",
                  [ops.approx_matmul_lut_bank(o[key], o["qw"], tabs)],
                  [ref.approx_matmul_lut_bank_experts_ref(
                      o[key], o["qw"], tabs.to(torch.int32))],
                  f"plain {what} {key}")
        for key in ("xb", "x"):
            fused("fused_matmul_bank", ops.fused_matmul_lut_bank,
                  ref.fused_matmul_bank_experts_ref, o[key], o["w"], tabs,
                  o[f"sp_{key}"], f"{what} {key}")
        del o
    print(f"[experts] {cases} expert-form cases equal the plain versions "
          f"bit for bit")

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    lookup_rate = sms * LOOKUPS_PER_SM_CLOCK * clock_hz
    int_rate = sms * INT32_OPS_PER_SM_CLOCK * clock_hz
    rows = []
    for p_, e, m, k, n in EXPERT_FULL:
        what = f"P={p_} E={e} {(m, k, n)}"
        idx = torch.arange(p_, device=device) % profile.shape[0]
        tabs = profile.index_select(0, idx)
        products = p_ * e * m * k * n
        for kernel, op, floats in (
                ("lut_matmul_bank", ops.approx_matmul_lut_bank, False),
                ("fused_matmul_bank", ops.fused_matmul_lut_bank, True)):
            if not floats:
                a = _codes((p_, e, m, k), gen, device)
                w = _codes((e, k, n), gen, device)
                sp = ()
            else:
                a = _floats((p_, e, m, k), gen, device)
                w = _floats((e, k, n), gen, device, 0.2)
                sp = pair_scalars(calibrate_slices(a), calibrate_slices(w),
                                  p_, e)
            call = (lambda: op(a, w, tabs, *sp, raw=True)) if sp else (
                lambda: op(a, w, tabs))
            # today's E launches, their slices cut before the clock
            slices = [a[:, j].contiguous() for j in range(e)]
            sc = [[v.reshape(p_, e)[:, j].contiguous() if isinstance(
                v, torch.Tensor) else v for v in sp] for j in range(e)]

            def loop():
                return [op(slices[j], w[j], tabs, *sc[j],
                           **({"raw": True} if sp else {}))
                        for j in range(e)]
            got = call()
            per = loop()
            want = ([torch.stack(per, dim=1)] if not sp else
                    [torch.stack([q[i] for q in per], dim=1)
                     for i in range(3)])
            check(kernel, got if sp else [got], want,
                  f"{e} launches without the axis, {what}")
            del per, want, got
            ms = _time(call, reps=2, warmup=1)
            loop_ms = _time(loop, reps=1, warmup=0)
            nbytes = (a.numel() + w.numel() + p_ * e * m * n
                      + (p_ * e * (m + n) if sp else 0)) * 4 \
                + p_ * 65536 * 2
            rows.append({"kernel": kernel, "form": "experts", "lanes": p_,
                         "experts": e, "M": m, "K": k, "N": n, "ms": ms,
                         "e_launches_ms": loop_ms,
                         "items": fm.k_split(
                             p_ * e, m, k, n, sms,
                             quant8=kernel == "fused_matmul_bank").items,
                         **_bounds(products / lookup_rate,
                                   int_seconds(0, 2 * products, int_rate),
                                   nbytes / HBM_BYTES_PER_S)})
            print(f"[experts] {kernel} {what}: one launch {ms:.3f} ms, "
                  f"{e} launches without the axis {loop_ms:.3f} ms, bound "
                  f"{rows[-1]['bound_ms']:.4f} ms ({rows[-1]['limit']}); "
                  f"equal bit for bit")
            del a, w, slices, sc
            torch.cuda.empty_cache()
    rows += phase_experts_cell(device)
    rows += _experts_composed(device, gen, tables, check,
                              (lookup_rate, int_rate))
    lowrank_cases, lowrank_rows = _experts_lowrank(
        device, gen, max_err, sms * FP32_LANES_PER_SM * 2 * clock_hz)
    rows += lowrank_rows
    wall = time.perf_counter() - t0
    print(f"[experts] {cases} cases equal bit for bit; phase {wall:.1f} s")
    return {"cases": cases, "max_abs_err": max_err, "rows": rows,
            "lowrank_cases": lowrank_cases, "wall_s": wall}


def _time(fn, reps: int, warmup: int) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(shapes: dict, device) -> dict:
    """Per main-path shape: kernel and plain times (ms) and the bound,
    the largest of the table lookups at 32 a clock per SM, the integer
    ops (``int_ops_per_product``: logic ops at 64 a clock per SM, all of
    them at 128 over the ALU and FMA pipes; ``int_seconds``) and the
    bytes.
    The banked kernels run the activations the all-layers sweeps give
    them: shared at conv_init, banked after; K4 the 17-lane case-study
    bank, K7 and K5 one 16-bit composed multiplier, K8 and K6 the wide
    study's mixed-width bank; then K10/K11 (``_bitsim_timing``)."""
    import torch
    from repro_torch.approx.quant import calibrate, quantize
    from repro_torch.kernels import fused_matmul as fm
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=device).manual_seed(1)
    t = _tables(device)
    luts, wide = t["case"], t["wide"]
    luts32 = luts.to(torch.int32)
    n_wide = wide["luts"].shape[0]
    n_narrow = int((wide["masks"] == 0).sum())
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    lookup_rate = sms * LOOKUPS_PER_SM_CLOCK * clock_hz
    int_rate = sms * INT32_OPS_PER_SM_CLOCK * clock_hz
    rows = []
    # (logic, arith) integer ops per product of each bank lane, from its
    # mask and code, and of all the bank's lanes
    wide_int = [int_ops_per_product(mk, kd, kk) for mk, (kd, kk) in zip(
        wide["masks"].tolist(), wide["codes"].tolist())]
    bank_int = tuple(map(sum, zip(*wide_int)))
    # the device work one K3 / K4 call through kernels.ops queues (raw
    # outputs: the f32 epilogue is the caller's), at a shape whose K is
    # split (head: kernel + memset) and one whose K is not
    per_call_shapes = {"head": ("fused_matmul", "fused_matmul_bank"),
                       "s0_b0_conv1": ("fused_matmul", "fused_matmul_bank")}
    per_call = {}

    def row(kernel, label, mkn, lanes, lookups, int_ops, nbytes, call,
            plain, launch=None):
        reps, plain_reps = (20, 2) if kernel.startswith("lut") else (10, 1)
        split = fm.k_split(lanes, *mkn, sms, quant8=kernel in (
            "fused_matmul", "fused_matmul_bank"))
        if launch is not None:                  # the launch alone, and
            launch_ms = {                       # its device time
                "launch_ms": _time(launch, reps=reps, warmup=3),
                "device_ms": _device_ops(launch, reps)["device_ms"]}
        else:
            launch_ms = {}
        rows.append({
            "kernel": kernel, "layer": label, "M": mkn[0], "K": mkn[1],
            "N": mkn[2], "lanes": lanes, "items": split.items,
            "splits": split.splits, "lookups": lookups,
            "int_ops": int_ops, "bytes": nbytes,
            "ms": _time(call, reps=reps, warmup=3), **launch_ms,
            "plain_ms": _time(plain, reps=plain_reps, warmup=1),
            **_bounds(lookups / lookup_rate,
                      int_seconds(*int_ops, int_rate),
                      nbytes / HBM_BYTES_PER_S)})

    for label, (m, k, n) in shapes.items():
        mkn = (m, k, n)
        shared = label == "conv_init"
        qa = _codes((m, k), gen, device)
        qw = _codes((k, n), gen, device)
        qab = qa if shared else _codes((N_LANES, m, k), gen, device)
        out_b = m * n * 4
        lut_b = 65536 * 2
        row("lut_matmul", label, mkn, 1, m * k * n, (0, 2 * m * k * n),
            qa.numel() * 4 + qw.numel() * 4 + lut_b + out_b,
            lambda: ops.approx_matmul_lut(qa, qw, luts[0]),
            lambda: ref.approx_matmul_lut_ref(qa, qw, luts32[0]))
        row("lut_matmul_bank", label, mkn, N_LANES, N_LANES * m * k * n,
            (0, 2 * N_LANES * m * k * n), qab.numel() * 4 + qw.numel() * 4 + N_LANES * (lut_b + out_b),
            lambda: ops.approx_matmul_lut_bank(qab, qw, luts),
            lambda: ref.approx_matmul_lut_bank_ref(qab, qw, luts32))
        del qa, qw, qab
        # fused: f32 operands in; acc (or two limbs) and code sums out
        x = _floats((m, k), gen, device)
        w = _floats((k, n), gen, device, 0.2)
        sums_b = (m + n) * 4
        # (name, lanes, x, tables, codes, bits, lookups and (logic,
        # arith) integer ops per product of all lanes)
        fused = [("fused_matmul", 1, x, luts[0], (), 8, 1, (0, 2)),
                 ("fused_matmul_bank", N_LANES,
                  x if shared else _floats((N_LANES, m, k), gen, device),
                  luts, (), 8, N_LANES, (0, 2 * N_LANES)),
                 ("fused_composed_matmul", 1, x, wide["luts"][-5],
                  (wide["masks"][-5:-4], wide["codes"][-5:-4]), 16, 4,
                  wide_int[-5]),
                 ("fused_composed_matmul_bank", n_wide,
                  x if shared else _floats((n_wide, m, k), gen, device),
                  wide["luts"], (wide["masks"], wide["codes"]),
                  wide["bits"], 4 * (n_wide - n_narrow) + n_narrow,
                  bank_int)]
        for name, lanes, xin, tab, codes, bits, per_product, ints in fused:
            op = getattr(ops, {"fused_matmul": "fused_matmul_lut",
                               "fused_matmul_bank": "fused_matmul_lut_bank",
                               "fused_composed_matmul":
                                   "fused_composed_matmul_lut",
                               "fused_composed_matmul_bank":
                                   "fused_composed_matmul_lut_bank"}[name])
            plain = getattr(ref, f"{name}_ref")
            sp = _scalars(xin, w, bits)
            fp, ip = fm.pack_scalars(lanes, device, *sp)
            packed = fm.pack_codes(lanes, device, *codes) if codes else ()
            tab32 = tab.to(torch.int32)
            limbs = 2 if codes else 1
            nbytes = (xin.numel() * 4 + w.numel() * 4
                      + lanes * (lut_b + limbs * out_b + sums_b))
            # K3/K4 also by their launch alone, with the scalars made
            sc = fm.lane_scalars(lanes, device, *sp)
            launch = (None if codes else
                      lambda: getattr(fm, name)(xin, w, tab, sc))
            row(name, label, mkn, lanes, per_product * m * k * n,
                (ints[0] * m * k * n, ints[1] * m * k * n), nbytes,
                lambda: op(xin, w, tab, *codes, *sp, raw=True),
                lambda: plain(xin, w, tab32, *packed, fp, ip), launch)
            if name in per_call_shapes.get(label, ()):
                per_call[f"{name} {label}"] = _device_ops(
                    lambda: op(xin, w, tab, *sp, raw=True))
        # two-step composed on codes: K5 one 16-bit loa4 multiplier, K6
        # the wide study's bank, each on the codes the two-step datapath
        # makes of K7's and K8's operands (per-lane widths give per-lane
        # codes of both operands), so both pairs do the same lookups
        qa, qw = (quantize(v, calibrate(v, 16)) for v in (x, w))
        xw = fused[3][2]
        qab = quantize(xw, calibrate(xw, wide["bits"], lanes=xw.ndim == 3))
        qwb = quantize(w, calibrate(w, wide["bits"]))
        del x, w, fused, xw
        lut16 = wide["luts"][-5]
        mask1, code1 = wide["masks"][-5:-4], wide["codes"][-5:-4]
        row("composed_matmul", label, mkn, 1, 4 * m * k * n,
            (wide_int[-5][0] * m * k * n, wide_int[-5][1] * m * k * n),
            (m * k + k * n) * 4 + lut_b + 2 * out_b,
            lambda: ops.composed_matmul_lut(qa, qw, lut16, mask1,
                                            ("loa", 4), raw=True),
            lambda: ref.composed_matmul_limbs_ref(
                qa, qw, lut16.to(torch.int32), mask1, code1))
        wide32 = wide["luts"].to(torch.int32)
        row("composed_matmul_bank", label, mkn, n_wide,
            (4 * (n_wide - n_narrow) + n_narrow) * m * k * n,
            (bank_int[0] * m * k * n, bank_int[1] * m * k * n),
            (qab.numel() + qwb.numel()) * 4 + n_wide * (lut_b + 2 * out_b),
            lambda: ops.composed_matmul_lut_bank(qab, qwb, wide["luts"],
                                                 wide["masks"], ("loa", 4),
                                                 raw=True),
            lambda: ref.composed_matmul_bank_ref(qab, qwb, wide32,
                                                 wide["masks"],
                                                 wide["codes"]))
        del qa, qw, qab, qwb
    for r in rows:
        print(f"[timing] {r['kernel']:26s} {r['layer']:12s} "
              f"M={r['M']:6d} K={r['K']:4d} N={r['N']:3d} x{r['lanes']:2d} "
              f"({r['items']} items x {r['splits']} K ranges): "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['limit']}, "
              f"{r['bound_ms'] / r['ms']:.1%})")
    for key, v in per_call.items():
        print(f"[timing] {key}: one call through kernels.ops queues "
              f"{v['count']} device op(s), {v['device_ms']:.4f} ms on the "
              f"device: {v['names']}")
    over = {k: v for k, v in per_call.items()
            if k.startswith("fused_matmul ") and v["count"] > 2}
    if over:
        raise AssertionError(f"a K3 call queues more than its kernel and "
                             f"one memset: {over}")
    for name in ("fused_matmul", "fused_matmul_bank"):
        sel = [r for r in rows if r["kernel"] == name]
        print(f"[timing] {name}: ten shapes {sum(r['ms'] for r in sel):.4f}"
              f" ms through kernels.ops, "
              f"{sum(r['launch_ms'] for r in sel):.4f} ms the launch alone, "
              f"{sum(r['device_ms'] for r in sel):.4f} ms on the device")
    rows += _bitsim_timing(device, lookup_rate, int_rate)
    for name in ("bitsim_pop", "bitsim"):
        sel = [r for r in rows if r["kernel"] == name]
        print(f"[timing] {name}: two cases {sum(r['ms'] for r in sel):.4f} "
              f"ms through kernels.ops, "
              f"{sum(r['launch_ms'] for r in sel):.4f} ms the launch alone, "
              f"{sum(r['device_ms'] for r in sel):.4f} ms on the device, "
              f"depth floor {sum(r['depth_floor_ms'] for r in sel):.5f} ms")
    fp32_rate = sms * FP32_LANES_PER_SM * 2 * clock_hz
    rows += _lowrank_timing(device, fp32_rate)
    return {"lookup_rate_per_s": lookup_rate,
            "alu_int_ops_per_s": int_rate, "kernels_per_call": per_call,
            "wide_bank": t["wide_names"],
            "wide_bank_int_ops_per_product": wide_int,
            "fp32_flops_per_s": fp32_rate, "rows": rows}


def _device_ops(call, reps: int = 1, attempts: int = 3) -> dict:
    """The device work of one call, under ``torch.profiler`` over
    ``reps`` calls: the count of device-side entries (kernels and
    memsets) a call queues, their names and their device time a call.
    A window's last kernel record can arrive after the window closes, and
    its first one can be lost while tracing starts (one run saw 9 of 10
    calls in each of three windows), so each window starts and ends with
    two marker kernels (``torch.cuda._sleep``'s spin kernel, which no
    call here queues), left out of the count; a count that is still not
    a whole number of calls is profiled again, up to ``attempts`` times,
    and fails then (the call's kernel at least must show)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()                                      # warm: builds, caches
    torch.cuda.synchronize()
    counts = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                torch.cuda._sleep(1000)
            for _ in range(reps):
                call()
            for _ in range(2):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and "spin_kernel" not in e.key]
        count = sum(e.count for e in dev)
        counts.append(count)
        if count >= reps and count % reps == 0:
            break
    else:
        raise AssertionError(f"the profiler saw no whole number of calls' "
                             f"device work in {reps} calls: {counts}")
    device_ms = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
                    for e in dev) / 1e3 / reps
    return {"count": count // reps, "names": sorted(e.key[:60] for e in dev),
            "device_ms": device_ms, "profiled_windows": len(counts)}


def _bounds(lookup_s: float, int_s: float, bytes_s: float) -> dict:
    """A timing row's floors in ms and its bound, the largest of them;
    ``bound_by`` is "operations" (lookups or integer ops) or "bytes",
    ``limit`` names the floor."""
    floors = {"lookups": lookup_s * 1e3, "integer ops": int_s * 1e3,
              "bytes": bytes_s * 1e3}
    limit = max(floors, key=floors.get)
    return {"ops_ms": floors["lookups"], "int_ms": floors["integer ops"],
            "bytes_ms": floors["bytes"], "bound_ms": floors[limit],
            "limit": limit,
            "bound_by": "bytes" if limit == "bytes" else "operations"}


def _lowrank_timing(device, fp32_rate: float) -> list:
    """K9 at each serve shape with the served multiplier's rank-4
    factors, beside its plain version, its bound and a yardstick that is
    not a port: ``torch.matmul`` in f32 (TF32 off) of the pre-gathered
    tables concatenated over r, (M, R·K) @ (R·K, N), which computes the
    same sum.  Bound: the larger of the codes, tables and output moved
    once at 3.35 TB/s and the flops at the faster of two f32-accurate
    rates — 3 x 2·M·K·N·R at the dense TF32 tensor-core peak (the
    3xTF32 split) or 2·M·K·N·R at the SIMT FP32 rate (132 SMs x 128
    lanes x 2 x clock), kept as ``ops_ms_simt``.  Each row names the
    regime and grid the kernel's plan gives the shape."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.lowrank_matmul import plan
    gen = torch.Generator(device=device).manual_seed(2)
    _, factors = _served_factors(device)
    u, v = factors["R=4"]
    r = u.shape[0]
    rows = []
    for label, (m, k, n) in LOWRANK_SHAPES.items():
        qa = _codes((m, k), gen, device)
        qw = _codes((k, n), gen, device)
        ua = u[:, qa.long()].permute(1, 0, 2).reshape(m, r * k).contiguous()
        vw = v[:, qw.long()].reshape(r * k, n).contiguous()
        flops = 2 * m * k * n * r
        nbytes = (m * k + k * n + 2 * r * 256 + m * n) * 4
        ops_ms_simt = flops / fp32_rate * 1e3
        ops_ms = min(ops_ms_simt, TF32_SPLIT_PRODUCTS * flops
                     / TF32_FLOPS_PER_S * 1e3)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        p = plan(m, k, n, r)
        row = {"kernel": "lowrank_matmul", "layer": label, "M": m, "K": k,
               "N": n, "R": r, "flops": flops, "bytes": nbytes,
               "regime": p.regime, "blocks": p.blocks, "splits": p.splits,
               "ms": _time(lambda: ops.lowrank_matmul(qa, qw, u, v),
                           reps=20, warmup=3),
               "plain_ms": _time(lambda: ref.lowrank_matmul_ref(qa, qw, u,
                                                                v),
                                 reps=5, warmup=1),
               "gathered_matmul_ms": _time(lambda: torch.matmul(ua, vw),
                                           reps=20, warmup=3),
               "ops_ms": ops_ms, "ops_ms_simt": ops_ms_simt,
               "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
        rows.append(row)
        print(f"[timing] lowrank_matmul {label:18s} M={m:4d} K={k:4d} "
              f"N={n:4d} R={r} ({p.regime}, {p.blocks} blocks, "
              f"{p.splits} K slices): {row['ms']:.4f} ms (plain "
              f"{row['plain_ms']:.4f} ms, gathered matmul "
              f"{row['gathered_matmul_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.5f} ms by {row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%}; SIMT bound "
              f"{max(ops_ms_simt, bytes_ms):.5f} ms)")
    return rows


def _bitsim_timing(device, lookup_rate: float, int_rate: float) -> list:
    """K11 on one CGP generation of the ``small`` ladder (32 candidates,
    8192 vectors) and K10 on the exact 8-bit circuits over exhaustive
    planes (65 536 vectors), beside their bounds: through ``kernels.ops``
    (``ms``), the launcher alone (``launch_ms``), the device time and the
    device ops of one call through ``ops`` from ``torch.profiler``
    (``device_ms``, ``kernels_per_call``: must be 1), the walk
    ``bitsim.walk_plan`` picks, the level depth (the largest of the
    candidates') and, as information beside the bound, the depth floor:
    depth x one level's wait measured by ``bitsim.probe_round_ms`` (a
    dependent shared load, an add, a store and a barrier in a block of
    the level walk's 128 threads).  The bound: a gate-word step is
    shared-memory traffic, one access per input its gate reads plus the
    store, counted over the active gates only (the inactive ones do not
    change the outputs), and one logic op (the gate); bytes: planes,
    netlist arrays and outputs, each once."""
    from repro_torch.core.gates import GATE_ARITY
    from repro_torch.core.netlist import exhaustive_inputs
    from repro_torch.core.seeds import array_multiplier, ripple_carry_adder
    from repro_torch.kernels import bitsim as kbitsim
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.approx_matmul import sm_count

    def accesses(nls, words):
        return sum(int((GATE_ARITY[nl.funcs][nl.active_mask()] + 1).sum())
                   for nl in nls) * words

    def gates(nls, words):
        return sum(int(nl.active_mask().sum()) for nl in nls) * words

    cases = []
    for name, pop in _populations(device).items():
        words = pop["words"]
        cases.append(("bitsim_pop", f"{name} generation", pop["netlists"],
                      pop["tensors"], words, ops.bitsim_pop_planes,
                      kbitsim.bitsim_pop_words, ref.bitsim_pop_ref))
    for name, nl in (("mul8 exact", array_multiplier(8)),
                     ("add8 exact", ripple_carry_adder(8))):
        words = ops.words_to_device(ops.split_planes64(
            exhaustive_inputs(nl.n_i)), device)
        tens = ops.netlist_tensors((nl.funcs, nl.in0, nl.in1, nl.outputs),
                                   nl.n_i, device)
        cases.append(("bitsim", f"{name} exhaustive", [nl], tens, words,
                      ops.bitsim_planes, kbitsim.bitsim_words,
                      ref.bitsim_ref))
    round_ms = kbitsim.probe_round_ms(device)
    print(f"[timing] bitsim probe: one level's wait (dependent shared load, "
          f"add, store, barrier; 128 threads) {round_ms * 1e6:.2f} ns")
    rows = []
    for kernel, label, nls, tens, words, op, launch, plain in cases:
        n_i, w = words.shape
        n_o = nls[0].n_o
        steps, n_ops = accesses(nls, w), gates(nls, w)
        nbytes = (n_i * w + sum(t.numel() for t in tens)
                  + len(nls) * n_o * w) * 4
        depth = max(int(kbitsim.level_schedule(
            nl.funcs, nl.in0, nl.in1, nl.n_i)[0].max(initial=0))
            for nl in nls)
        per_call = _device_ops(lambda: op(*tens, words), reps=10)
        if per_call["count"] != 1:
            raise AssertionError(f"a {kernel} call through kernels.ops "
                                 f"queues more than its kernel: {per_call}")
        r = {"kernel": kernel, "layer": label, "candidates": len(nls),
             "words": w, "accesses": steps, "int_ops": (n_ops, 0),
             "bytes": nbytes,
             "walk": kbitsim.walk_plan(n_i, tens[0].shape[-1], len(nls), w,
                                       sm_count(device.index or 0)).walk,
             "depth": depth, "depth_floor_ms": depth * round_ms,
             "ms": _time(lambda: op(*tens, words), reps=20, warmup=3),
             "launch_ms": _time(lambda: launch(*tens, words), reps=20,
                                warmup=3),
             "device_ms": per_call["device_ms"],
             "kernels_per_call": per_call["count"],
             "plain_ms": _time(lambda: plain(*tens, words), reps=1,
                               warmup=1),
             **_bounds(steps / lookup_rate, int_seconds(n_ops, 0, int_rate),
                       nbytes / HBM_BYTES_PER_S)}
        rows.append(r)
        print(f"[timing] {kernel:26s} {label:18s} x{len(nls):2d} "
              f"{w:5d} words, {r['walk']} walk: {r['ms']:.4f} ms via ops, "
              f"{r['launch_ms']:.4f} ms the launch alone, "
              f"{r['device_ms']:.4f} ms on the device "
              f"({r['kernels_per_call']} device op a call; plain "
              f"{r['plain_ms']:.3f} ms; bound {r['bound_ms']:.6f} ms by "
              f"{r['limit']}, {r['bound_ms'] / r['ms']:.1%}; depth "
              f"{depth}, depth floor {r['depth_floor_ms']:.5f} ms)")
    return rows


def summary(compare: dict, main: dict, timing: dict) -> dict:
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        rows = [r for r in timing["rows"] if r["kernel"] == name]
        ops_ms = sum(max(r["ops_ms"], r.get("int_ms", 0.0)) for r in rows)
        bytes_ms = sum(r["bytes_ms"] for r in rows)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": main["launches"][name],
            "max_abs_err": compare["max_abs_err"][name],
            "ms": sum(r["ms"] for r in rows),
            "plain_ms": sum(r["plain_ms"] for r in rows),
            "bound_ms": sum(r["bound_ms"] for r in rows),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            # one PyTorch call computes K9's function: torch.matmul of
            # the pre-gathered tables; no single call computes the others
            "library_ms": (sum(r["gathered_matmul_ms"] for r in rows)
                           if name == "lowrank_matmul" else None)})
    return {"kernels": kernels}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.launch.case_study import main_path_shapes
    from repro_torch.models import resnet
    t0 = time.perf_counter()
    device = resolve_device(None)
    card = _smi("name,power.limit")
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    shapes = main_path_shapes(resnet.resnet_config(8), BATCH)
    walls = {}

    def timed(name, fn, *args):
        """``fn(*args)``, its wall kept in ``walls[name]``."""
        start = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - start
        print(f"[wall] {name}: {walls[name]:.1f} s")
        return out

    details = {"card": card, **timed("build", phase_build)}
    details["compare"] = timed("compare", phase_compare, shapes, device)
    details["main"], lib = timed("main", phase_main, device)
    details["compare"]["library"] = timed(
        "compare_library", phase_compare_library, lib, device,
        details["compare"]["max_abs_err"])
    details["experts"] = timed("experts", phase_experts, device)
    details["timing"] = timed("timing", phase_timing, shapes, device)
    for k, v in details["experts"]["max_abs_err"].items():
        details["compare"]["max_abs_err"][k] = max(
            details["compare"]["max_abs_err"][k], v)
    launches = details["main"]["launches"]

    def log(tag):
        return lambda s: print(f"[{tag}] {s}")
    # after the timing phase: with this path's ~2.5 million launches
    # before it, every short profiler window of the timing phase
    # (``_device_ops``) lost most of its kernel records (two runs)
    details["main"]["serve_continuous"] = timed(
        "serve_continuous", phase_serve_continuous, device, log("main"),
        launches)
    details["main"]["continuous_step_profile"] = timed(
        "continuous_step_profile", phase_profile_continuous, device)
    # after the timing phase too (its profiler windows; ROADMAP.md Watch)
    details["main"]["profiles"] = timed("profiles", phase_profiles, device,
                                        log("main"), launches)
    details["main"]["serve_encdec"] = timed(
        "serve_encdec", phase_serve_encdec, device, log("main"), launches)
    details["main"]["serve_families"] = timed(
        "serve_families", phase_serve_families, device, log("main"),
        launches)
    details["main"]["train"] = timed("train", phase_train, device,
                                     log("train"), launches)
    details["main"]["objectives"] = timed(
        "objectives", phase_objectives, device, log("main"), launches)
    details["main"]["evolve"] = timed("evolve", phase_evolve, device,
                                      log("main"), launches)
    details["main"]["mesh"] = timed(
        "mesh", phase_mesh, device, log("mesh"), launches,
        details["main"]["heterogeneous_pallas"])
    details["main"]["dryrun"] = timed("dryrun", phase_dryrun, device,
                                      log("dryrun"), launches)
    details["total_s"] = time.perf_counter() - t0
    details["phase_walls_s"] = walls
    print("[wall] phases " + json.dumps(
        {k: round(v, 1) for k, v in walls.items()}))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(f"[done] {details['total_s']:.1f} s")
    print(card)
    print(json.dumps(summary(details["compare"], details["main"],
                             details["timing"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
