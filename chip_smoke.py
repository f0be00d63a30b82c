#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card and check it.

    python3 chip_smoke.py            # needs one CUDA card; exit 0 = all phases passed

Phases:
  build  compile the four CUDA sources with nvcc, one process each, all
         started together, from the sources in this checkout;
  A      the RMNP kernel (csrc/rmnp_update.cu; apply and precondition, one
         line each) against its plain versions at the four gpt2-small
         bucket shapes, llama-130m's five (2048x768 at split K = 6),
         the 13 of deepseek-v2-lite-16b cut to 3 layers (the expert
         stacks 2048x2816 and 1408x2048 at L = 128 among them), the 7 of
         xlstm-350m cut to 12 layers (the 2048x4 gate matrices, the
         r_gates stack at L = 24) and the 10 of jamba cut to layers 3-4
         (the expert stacks at L = 17, x_proj 8192x288; 17x4096x28672 in
         the main path's types only and without the bit-for-bit checks),
         paligemma-3b's tied
         embedding 1x257280x2048 (the two-sweep path: its slab exceeds a
         cluster's shared memory), the 6 of yi-9b cut to 2 layers (the
         64000x4096 embedding, 4096x22016) and the 5 of olmoe-1b-7b cut to
         2 layers (the expert stacks at L = 128 and 136), fp32 and bf16
         momentum, bf16 weights (the main
         path's), and for the apply kernel also fp32 weights, whose update
         w_new - w is held against the plain version's at its own
         magnitude; per bucket its time, bound, rate, split (K, R, C) and
         path, failing if a bucket but paligemma's embedding takes the
         two-sweep path (or that one does not); bit for bit,
         a stacked launch against its slices launched alone (both forms)
         and, in fp32, apply against precondition followed by the two-pass
         engine's eager ops; the ptxas report of each instantiation;
  B      the flash-attention forward kernels (bf16: csrc/flash_attention_fwd.cu;
         fp32, 3xTF32: csrc/flash_attention_fwd_tf32.cu; both on the tensor
         cores) against their plain version, in each type at B=8 S=1024
         H=K=12 hd=64, causal and not, a GQA shape (H=8, K=2) with a ragged
         S (causal and not), hd 32 and 16 with G=4, and S in {1, 63, 65,
         129}, each fp32 case also against a float64 softmax; bf16 also at
         hd 128: qwen3-4b's prefill shape (B=8 S=1024 H=32 K=8) causal and
         not, the ragged GQA shape causal and not, and S in {1, 63, 65,
         129}; bf16 also at hd 128 at yi-9b's prefill shape (H=32 on K=4,
         G = 8) and olmoe-1b-7b's (H=K=16, G = 1), causal (timed) and not,
         and 20 seeds of each causal and 20 not; bf16 also at MLA's q/k 192,
         v 128 with v a strided column
         slice: deepseek-v2-lite's prefill shape (B=8 S=1024 H=K=16) causal
         and not, a ragged S causal and not, and S in {1, 63, 65, 129},
         each also against a contiguous copy of v bit for bit; bf16 also
         at hd 256: paligemma-3b's prefill shape (B=8 S=1024 H=8 K=1)
         causal (timed) and not, a ragged S=1000 (timed) and S in {1, 63,
         65, 129}, and 20 seeds of the prefill shape; bf16 also at hd 96
         (three 32-column sub-tiles under the 64-byte swizzle):
         phi3-mini-3.8b's (96, 96) at its prefill shape (B=8 S=1024
         H=K=32) and minicpm3-4b's MLA (96, 64) at its (H=K=40, v a
         strided column slice), each causal (timed) and not, a ragged
         S=1000 causal and not, S in {1, 63, 65, 129}, and 20 seeds of
         each prefill shape causal and 20 not; fp32 also at each of its
         wide builds (FP32_WIDE): qwen3-4b's (128, 128) (H=32 K=8),
         phi3-mini's (96, 96) (H=K=32), minicpm3-4b's (96, 64) (H=K=40)
         and deepseek-v2-lite's (192, 128) (H=K=16), v a strided column
         slice at both MLA pairs, and paligemma-3b's (256, 256) (H=8 K=1),
         each at B=8 S=1024 causal (timed) and not, a ragged S=1000 causal
         and not and S in {1, 63, 65, 129}; two
         launches must give the same bits; 40 seeds of a
         non-causal S=1000 GQA head must all hold the limit in each type
         (20 more at hd 128, 20 at (192, 128) and 20 at hd 256 in bf16; 10
         at each fp32 wide build); the
         ptxas report of both kernels is printed, and cuobjdump must find
         HGMMA in each instantiation of each (both kernels' (hd, hdv)
         (16, 16) to (128, 128), (96, 64), (192, 128) and (256, 256));
         every bf16 build must
         spill nothing, hold USETMAXREG (its producer warpgroup's
         registers go to the consumers) and have no wgmma that ptxas
         serialised, every fp32 build must spill nothing, and the
         registers and spills of both go on the kernels line
         (kernels/report.py reads both); an fp32 row's bound is that of
         its 3xTF32 products on the tensor cores, the FFMA bound is
         recorded beside it, and a bf16 row's kernel floor with P.V as three
         products beside its bound; F.scaled_dot_product_attention is timed
         beside it as a yardstick only;
  C      the main path at full width: 3 steps of
         repro_torch.launch.train.train("gpt2-small", reduced=False,
         optimizer="rmnp", single-pass engine, use_kernel=True, batch=8,
         seq=1024) with 4 apply-kernel launches per step; one step of the
         two-pass bucketed engine (4 precondition launches); one step with
         attn_impl="pallas" through make_train_step, whose final hidden
         state and loss must match dense attention's from the same init,
         while a non-causal attention, the control, must not;
  C3f    the same in fp32 (gpt2-small at full width with dtype="float32"):
         one single-pass RMNP step with attn_impl="pallas" (the fp32 flash
         kernel, 24 launches) against dense attention from one init, loss
         and final hidden state within 1e-4, the non-causal control 10x
         outside; then 3 more steps of each, timed, and peak memory;
  T1     the same for qwen3-4b cut to its first 2 layers at full width in
         fp32 (B=8, S=1024, seed 0) through the fp32 kernel's (128, 128)
         build (4 launches a step; yi-9b, olmoe-1b-7b and jamba take the
         same build): C3f's checks and tolerances, then 2 timed steps;
  T2     the same for deepseek-v2-lite-16b cut to 3 layers (m1_config)
         through the (192, 128) build, v read in place (5 launches a step:
         the dense first layer is a prefix, not recomputed);
  E      the GEMM kernel (csrc/matmul.cu) in the three launches of a
         Newton-Schulz step (Gram, polynomial, apply) at gpt2-small's four
         buckets, each against a float64 product on the card, with a
         mutation control that must fail; five iterations kernel against
         plain; ns_step3 on a stack against ns_step on its slices; a ragged
         stack and a 2-D matrix taken on its transposed side; the ptxas
         report of each instantiation is printed, and cuobjdump must find
         HGMMA in all four; each launch's bound is that of its 3xTF32
         products on the tensor cores, the FFMA bound is recorded beside
         it; torch.bmm/baddbmm are timed beside it as yardsticks only;
  K      the launch census at gpt2-small's full width (bf16, seed 0): a
         single-pass RMNP step, a two-pass one, a bucketed Muon step
         (optimizer calls on random gradients) and a forward with
         attn_impl="pallas" (B=8, S=1024), each once under torch.profiler:
         per launch key the count recorded on meta tensors
         (kernels/introspect.py; optimizer_launches for the steps),
         LAUNCHES and the profiler's kernel events agree, and each event's
         instantiation, grid, block and shared memory are the recorded
         launch's (kernels/census.py); optimizer_fp32_buffers is 2 for the
         single-pass step at each bucket (the gathered fp32 gradient the
         kernel reads and the fp32 momentum it writes) and more for the
         two-pass one; one update_apply's device peak above what it returns
         stays within one fp32 copy of the largest bucket (the two-pass
         update's, the control, does not), its rise and the old values it
         leaves alive beside the new are printed, and the apply kernel alone
         raises the peak by its outputs only; at most K_SECONDS;
  C4     Muon on the main path at full width: 3 single-pass steps with 40
         matmul3 and 20 ns_poly3 launches each, one per-leaf step (the 2-D
         kernels for the embedding), one bucketed step each of NorMuon,
         Muown and Nora, and the preconditioning time per step of RMNP
         against Muon (update_apply, CUDA events around each of 10 calls:
         median, min and max, back to back and with the card held busy
         while each call is enqueued, which reads the card's time alone);
  D      a small input: reduced gpt2 with attn_impl="pallas", 3 single-pass
         steps under RMNP and under Muon with the kernels on the card against
         the same steps with the plain versions on the CPU; reduced qwen3
         (GQA, H=8 K=2 hd=16, fp32, the fp32 flash kernel in the prefill)
         served for a prefill and 8 decode steps, card against CPU: the
         same greedy tokens, logits within 1e-4 of the largest; reduced
         deepseek-v2-lite-16b and minicpm3-4b (MLA, MoE; fp32, the fp32
         flash kernel) card against CPU: loss and aux, every gradient,
         the MoE routing, served tokens and logits; and the same for
         reduced xlstm-350m and jamba-v0.1-52b (the SSM mixers), and for
         reduced models at their full configs' head dims (full_head_dims),
         each fp32 wide build through a whole model: qwen3-4b at hd
         128, phi3-mini at 96, paligemma-3b at 256, minicpm3-4b's MLA at
         (96, 64) and deepseek-v2-lite's at (192, 128);
  S      serving qwen3-4b at full width (bf16, seed 0, B=8, T=1024, 128 new
         tokens, S_max=1152) through repro_torch.launch.serve.serve and the
         step functions: S1 the prefill with attn_impl="pallas" (the bf16
         kernel at hd 128, 36 launches, counted) and "dense" from one set of
         parameters, last-token logits within S_LOGIT_TOL, and a
         non-causal prefill outside it; S2 the decode steps' logits for the
         first 16 generated tokens against a teacher-forced dense forward
         within S_LOGIT_TOL, and decoding at pos + 1 outside it; S3 prefill
         ms in each mode, decode ms a step over 127 steps (median, min,
         max), tokens per second and peak device memory;
  H      phase S's checks and timings for phi3-mini-3.8b at full width
         (32 layers, H=K=32 at hd 96; B=8, T=1024, 128 new tokens,
         S_max=1152): 32 launches of the (96, 96) kernel a prefill;
  N      the same for minicpm3-4b (62 layers of MLA, H=K=40 at q/k 96 and
         v 64, the tied 73448-row embedding): 62 launches of the (96, 64)
         kernel a prefill, v read in place from the up-projection;
  Y      phase S's checks and timings for yi-9b at full width and depth
         (48 layers, H=32 on K=4 at hd 128; 8,829,407,232 parameters):
         48 launches of the hd-128 kernel a prefill;
  M1     deepseek-v2-lite-16b cut to its first 3 layers (the dense prefix
         and 2 MoE units) at full width, trained with single-pass RMNP
         (B=8, S=1024, bf16, seed 0): 3 timed steps, 13 apply launches
         each, tokens/s and peak memory; a second run equals the first bit
         for bit after 2 steps; the per-leaf engine equals the single-pass
         one bit for bit on the expert stacks;
  V      the dry run (launch/dryrun.py, on meta tensors, nothing run on
         the card; recorded in a process of its own from the end of the
         build on, beside the phases on the card) of the windows of C1,
         S3 and M1: each window's
         predicted peak (the dry run's peak, the arguments it was given in
         it, plus what the phase held at its reset_peak_memory_stats beyond
         those arguments, read there) within V_MEM_TOL of the phase's
         measured peak, and the dry run's rise over its held arguments
         within V_MEM_TOL of the measured rise; beside it, per step, its
         FLOPs and model_flops and the phase's measured step, prefill or
         decode time over the record's roofline bound (reported, not
         gated);
  M2     serving deepseek-v2-lite-16b at full width and depth (bf16, seed
         0, B=8, T=1024, 128 new tokens, S_max=1152) through
         launch/serve.serve with the flash prefill (27 launches of the
         (192, 128) kernel, counted): init time and peak, prefill ms with
         flash and dense attention, decode ms a step, tokens per second,
         the serving peak; at capacity factor E / K (nothing dropped) the
         flash prefill against dense and decode against a teacher-forced
         dense forward within M_LOGIT_TOL, each control (non-causal;
         pos + 1) at least 4x outside, and the share of routings on
         which the flash and dense prefills agree;
  O      M2 for olmoe-1b-7b at full width and depth (16 layers, H=K=16 at
         hd 128 with qk_norm, 64 experts top-8; 6,919,624,704 parameters;
         16 launches of the hd-128 kernel a prefill): its controls must land
         outside the tolerance and 4x past the reading each controls;
  O2     olmoe-1b-7b cut to layers 0:2 trained as M1 (5 apply launches a
         step, the expert stacks at L = 128; per-leaf against single-pass
         on them);
  Y2     yi-9b cut to layers 0:2 trained as M1 (6 apply launches a step);
  X1     xlstm-350m cut to layers 0:12 at full width (6 layers each of
         mLSTM and sLSTM, 285,891,632 parameters, bf16, seed 0, B=8,
         S=1024; cut in depth to keep the script inside its time limit)
         trained with single-pass RMNP through launch.train.train: 2 timed
         steps with 7 apply launches each, tokens/s, peak memory; a second
         run equal bit for bit; one step
         under torch.profiler (device ops a step, idle share); one sLSTM
         and one mLSTM layer alone under the profiler, whose device ops 6
         times over give their share of the step;
  X2     serving xlstm-350m at full width (B=8, T=1024, 128 new tokens):
         prefill ms, decode ms a step, tokens/s, peak; 128 decode steps'
         logits against a teacher-forced forward, in bf16 (reported: the
         recurrences carry bf16 rounding, in the JAX package too) and in
         fp32 from the same weights within X2_FP32_TOL, and decoding from a
         zeroed cache outside S_LOGIT_TOL; the prefill and 8 decode steps
         under the profiler;
  J1     serving jamba-v0.1-52b cut to its first group of 8 layers (7
         mamba, 1 GQA, 16-expert MoE on every second; 13,295,235,072
         parameters; B=8, T=1024, 128 new tokens) with the flash prefill
         (one hd-128 launch, counted) and dense: init time and peak,
         prefill ms per mode, decode ms a step, serving peak; at capacity
         factor E / K with the reference run's routing replayed, flash
         against dense by the last logits and the final hidden state
         (non-causal control) and 64 decode steps against a forced forward
         (zeroed-cache control); the profiler as in X2;
  J2     jamba cut to layers 3-4 (a mamba layer with the MoE FFN, the GQA
         layer; 3,678,941,184 parameters) trained as X1 (10 apply launches
         a step, the expert stacks at L = 17), two runs bit for bit, one
         step profiled;
  P      paligemma-3b at full width and depth (18 layers, hd 256 with H=8
         on K=1, the tied 257280x2048 embedding; 2,508,793,856 parameters;
         bf16, seed 0): P1-P3 serve B=8 prompts of 1024 positions whose
         first 256 are image embeddings (launch/serve.prompt_batch, drawn
         from seed 1), 128 new tokens, as S serves qwen3-4b: the flash
         prefill (18 launches of the hd-256 kernel, counted) against dense
         and a non-causal control, the first 16 decode steps against a
         teacher-forced dense forward with the same image embeddings and a
         pos + 1 control, each within S's tolerance and each control
         outside it; prefill and decode ms, tokens/s, peak memory; P4
         trains it with single-pass RMNP as J2 (B=8, S=1024, 2 steps, 5
         apply launches a step, two runs bit for bit, one step profiled);
  G      musicgen-large the same way (48 layers, hd 64 with H=K=32;
         3,229,812,736 parameters): G1-G3 serve from 1024 audio frames a
         request (48 flash launches a prefill); G2's forced forward takes
         the prompt's frames followed by the generated tokens' embeddings;
         G4 trains it (3 apply launches a step);
  Q      the four examples of examples_torch/ on the card through their
         main(argv): quickstart card against CPU from one CPU init (every
         logged loss and grad norm and the dominance ratios within 1e-4),
         serve_batched's tokens equal to the CPU's, the faceoff at full
         width (--full --steps 20 --only adamw muon rmnp; each step's
         launches), and act 1 of fault_tolerant_restart (bit for bit);
  R      checkpointing and the non-finite guard on llama-130m at full width
         (B=8, S=1024, bf16, single-pass RMNP, 6 steps of
         repro_torch.launch.train.train, 5 apply launches a step):
         R1 two uninterrupted runs give the same parameter and state bits;
         R2 stop_at=3 with a checkpoint every 3 steps, then a restart to
         step 6, equals the uninterrupted run bit for bit, and so does a
         restart after a subprocess SIGKILLed (kill_at) with an async save
         in flight, which leaves no .tmp_step_* behind; R3 inject_fault
         "nan:*:2" under the guard skips step 2 naming the poisoned leaf and
         ends on the bits of a clean run that skipped step 2's update, and a
         sticky fault that exhausts the skip budget rewinds to the
         last-known-good checkpoint; R4 each of the four storage faults on a
         checkpoint written here raises CheckpointCorruptionError by name
         and restore_latest falls back to the step before, bit for bit; R5
         reports (no gate) the save() stall async against blocking, the
         step time with a write in flight and with the guard, each the
         median of 5 interleaved, and the bytes of one checkpoint;
  Z      ZeRO-2 through a NCCL group of one rank at full width (gpt2-small,
         B=8, S=1024, bf16, seed 0): Z1 five runs of 3 steps of
         train(zero2=True) (exact and int8 wire, serialized and pipelined,
         accum 2), 4 apply launches a step and no plain version run; the
         exact wire equals the world-1 replicated dp step bit for bit and
         pipelined equals serialized on each wire; the step times of each
         form beside C1's single-device step (5 rounds in turns, medians),
         peak memory, the distance from C1; Z2 each rank's slice of
         gpt2-small's four and llama-130m's five buckets padded 4 and 8
         ways through the RMNP apply kernel, and Newton-Schulz on slices of
         the 768x768 bucket, equal that slice of the whole stack's result
         bit for bit, pads zero; Z3 the int8 codes and scales of one
         bucket's gradient and one world-1 reduce-scatter on the card equal
         the CPU's, and a Muon ZeRO-2 step equals its ZeRO-0 step.

Every phase prints one JSON line per record, each with the seconds since its
phase began (``phase_s``), and a line with its total seconds; then a line
with the card's name and power limit, a line of every phase's seconds, a
``kernels`` line, and last ``{"ok": true, "device": ...}``. Any failed check
raises, and the script exits non-zero without the last line. Details go to
chiprun_out/chip_smoke.json (``phase_seconds`` beside the records).
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The card's peaks and the bound formulas (rmnp_bytes, attention_flops,
# attention_bounds, gemm_bound) live in src/repro_torch/launch/roofline.py.
BUCKETS = [(48, 768, 768), (12, 768, 6144), (12, 3072, 768), (1, 50432, 768)]
# llama-130m's five (its 2048x768 bucket takes split K = 6, which no gpt2
# bucket does; the untied head and the embedding are buckets of one)
LLAMA_BUCKETS = [(48, 768, 768), (12, 768, 4096), (12, 2048, 768), (1, 768, 32000),
                 (1, 32000, 768)]
# deepseek-v2-lite-16b cut to its first 3 layers (phase M1): 13 buckets, the
# expert stacks at L = 2 units x 64 experts, the dense prefix's FFN, the
# untied head and the embedding (1,670,119,424 matrix elements)
DS_BUCKETS = [(3, 512, 4096), (128, 1408, 2048), (2, 2048, 64), (3, 2048, 576),
              (3, 2048, 2048), (128, 2048, 2816), (3, 2048, 3072), (2, 2048, 5632),
              (1, 2048, 21888), (1, 2048, 102400), (2, 2816, 2048), (1, 10944, 2048),
              (1, 102400, 2048)]
# xlstm-350m cut to layers 0:12 (phase X1): 7 buckets, the mLSTM gate
# matrices 2048x4 (w_igate and w_fgate, L = 12), the sLSTM recurrent r_gates
# (6, 4, 256, 1024) at L = 24, the untied head and the embedding
# (285,835,264 matrix elements)
XLSTM_BUCKETS = [(24, 256, 1024), (18, 1024, 4096), (1, 1024, 50432), (12, 2048, 4),
                 (12, 2048, 1024), (18, 2048, 2048), (1, 50432, 1024)]
# jamba-v0.1-52b cut to layers 3-4 (phase J2): 10 buckets, the 16-expert
# stacks with the dense FFN at L = 17, mamba's x_proj 8192x288 (ragged
# columns), the router 4096x16, the untied head and the embedding
# (3,676,635,136 matrix elements)
J2_BUCKETS = [(1, 4096, 16), (2, 4096, 1024), (2, 4096, 4096), (1, 4096, 16384),
              (17, 4096, 28672), (1, 4096, 65536), (1, 8192, 288), (1, 8192, 4096),
              (17, 14336, 4096), (1, 65536, 4096)]
# paligemma-3b (phase P4): 5 buckets, its tied embedding 257280x2048 the
# largest (527 M elements; phase A times it, the only bucket on the RMNP
# kernel's two-sweep path); musicgen-large (phase G4): 3
# buckets, the embedding and the untied head in the 2048x2048 stack at L = 194
P_BUCKETS = [(1, 257280, 2048), (18, 2048, 32768), (18, 16384, 2048), (36, 2048, 256),
             (36, 2048, 2048)]
G_BUCKETS = [(48, 2048, 16384), (48, 8192, 2048), (194, 2048, 2048)]
# yi-9b cut to layers 0:2 (phase Y2): 6 buckets, the fused gate and up
# projection 4096x22016, the kv projections 4096x512 (K = 4 heads of 128),
# the untied head and the 64000-row embedding (870,318,080 matrix elements)
YI_BUCKETS = [(4, 4096, 512), (4, 4096, 4096), (2, 4096, 22016), (1, 4096, 64000),
              (2, 11008, 4096), (1, 64000, 4096)]
# olmoe-1b-7b cut to layers 0:2 (phase O2): 5 buckets, the expert stacks at
# L = 2 units x 64 experts (w_in 2048x2048 beside the 8 attention
# projections, w_out 1024x2048), the router 2048x64, the untied head and the
# embedding (1,045,692,416 matrix elements)
O_BUCKETS = [(128, 1024, 2048), (2, 2048, 64), (136, 2048, 2048), (1, 2048, 50432),
             (1, 50432, 2048)]
# Phase A runs a bucket above this many elements in the main path's types
# only (fp32 momentum, bf16 weights) and without the bit-for-bit checks,
# which hold several fp32 copies of it: jamba's 17x4096x28672 (2.0 G).
A_FULL_CHECKS_MAX = 2 ** 30
# Phase C3, flash against dense attention in bf16 at full width: the loss,
# and the final hidden state by relative Frobenius distance. The dense path
# rounds its probabilities to bf16 and the kernel keeps them in fp32, so the
# two differ by bf16 rounding carried through 12 layers; the tolerances sit
# a few times above the readings on an H100 (PERF.md), and a non-causal
# attention must land at least 10 times past the hidden-state tolerance.
C3_LOSS_TOL = 1e-3
C3_HIDDEN_TOL = 5e-2
# Phase C3f, the same in fp32: dense attention and the kernel (3xTF32, held
# at 1e-5 of each element in phase B) both compute in fp32, so the loss and
# the hidden state agree to fp32 rounding carried through 12 layers, orders
# of magnitude inside these tolerances; the control must still land at
# least 10 times past the hidden-state tolerance.
C3F_LOSS_TOL = 1e-4
C3F_HIDDEN_TOL = 1e-4
# Phases T1 and T2 (qwen3-4b and deepseek-v2-lite-16b cut in depth, fp32)
# hold C3f's tolerances: both sides compute in fp32 through 2 and 3 layers,
# against C3f's 12. Steps of each (the first, counted, then the timed ones).
T_STEPS = 3
# Newton-Schulz at gpt2-small's buckets, smaller side first: (L, m, n)
NS_BUCKETS = [(48, 768, 768), (12, 768, 6144), (12, 768, 3072), (1, 768, 50432)]
NS_COEFFS = (3.4445, -4.7750, 2.0315)
# Phase E, one launch against a float64 product: the plain version (cuBLAS,
# TF32 off) sums K fp32 products in FMA chains; the kernel sums 3xTF32
# products in slabs of 32 and adds the slabs and the chunks of K in fp32
# (kernels/matmul.py, csrc/matmul.cu). Their errors grow with the chains and
# differ in order. The kernel's worst error may be at most 8x the plain
# version's: room for the chains and for the spread of a maximum over up to
# 3e7 elements, while a skipped k-tile or a transposed operand moves the
# result by O(1) of its size, thousands of times more (the mutation control
# shows it).
E_ERR_FACTOR = 8.0
# Phase E, five Newton-Schulz iterations, kernel against plain, relative
# Frobenius distance. Each launch rounds at a relative ~sqrt(K) * 2^-24 <=
# 1.3e-5 (K = 50432) and the two sides round differently; the quintic
# neither grows nor shrinks a relative error by much (p'(s) / (p(s)/s) stays
# within about 1 in size on [0, 1.2]), so 5 iterations x 3 launches drift
# apart by at most ~2e-4.
NS_REL_TOL = 5e-4
RESULTS = {}
C1_FINAL = {}  # phase C1's final params and momentum (host copies), for phase Z
# each phase's seconds (its function, start to end; run_phase), and the
# start of the phase that runs now: every record a phase emits carries the
# seconds since its phase began as "phase_s" (unless it set its own)
PHASE_SECONDS = {}
PHASE_T0 = [None]


def emit(name, record):
    # a new dict: the caller may go on reading the record it passed
    if PHASE_T0[0] is not None:
        record = {"phase_s": time.perf_counter() - PHASE_T0[0], **record}
    RESULTS[name] = record
    print(json.dumps({"phase": name, **record}), flush=True)


def run_phase(label, fn, *args):
    """Run one phase, timing it into PHASE_SECONDS[label]."""
    PHASE_T0[0] = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[label] = time.perf_counter() - PHASE_T0[0]
        PHASE_T0[0] = None
        print(f"phase {label}: {PHASE_SECONDS[label]:.1f} s", flush=True)


def time_ms(fn, iters=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def per_call_ms(fn, iters=10, warmup=2, hold_cycles=0):
    """The time of each of ``iters`` calls, CUDA events around each. With
    ``hold_cycles`` the card spins that many cycles before each call
    (torch.cuda._sleep), so the host has enqueued the call before the card
    reaches it and the events read the card's time alone, not the host's."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if hold_cycles:
            torch.cuda.synchronize()
            torch.cuda._sleep(hold_cycles)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in events]


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def elementwise_err(got, want, rtol, atol_frac=1e-6):
    """(max |got - want|, worst ratio of |got - want| to its limit
    ``atol_frac * max|want| + rtol * |want|``, element by element). A ratio
    above 1 fails. The limit follows each element's own size, so a wrong
    value is caught wherever it exceeds that element's rounding, and not
    hidden under the largest element's. A stack above 2^28 elements is
    compared one slice of its leading dim at a time (the same numbers, in
    bounded memory: jamba's 17x4096x28672 bucket is 8 GB in fp32)."""
    if got.dim() < 3 or got.numel() <= 2 ** 28:
        diff = (got.float() - want.float()).abs()
        mag = want.float().abs()
        lim = atol_frac * mag.max() + rtol * mag
        return float(diff.max()), float((diff / lim).max())
    floor = atol_frac * max(w.float().abs().max() for w in want)
    err = ratio = 0.0
    for g, w in zip(got, want, strict=True):
        diff = (g.float() - w.float()).abs()
        err = max(err, float(diff.max()))
        ratio = max(ratio, float((diff / (floor + rtol * w.float().abs())).max()))
    return err, ratio


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_build():
    from repro_torch.kernels import build
    t0 = time.time()
    libs = ("flash_attention_fwd", "flash_attention_fwd_tf32", "matmul", "rmnp_update")
    # one nvcc per CUDA source, all started together; built even where a
    # library of the same source exists, for its ptxas report
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        built = list(pool.map(lambda name: build.build_library(name, force=True), libs))
    emit("build", {"seconds": round(time.time() - t0, 2),
                   "libraries": [lib.name for lib in built],
                   "ptxas": {"matmul": build.PTXAS_REPORTS.get("matmul", "")[-1500:]}})


def rmnp_instantiation(mangled):
    """``C32_apply_one_read_v32_w16`` for the mangled name of
    ``rmnp_kernel<C, APPLY, ONE_READ, TV, TW>``."""
    import re
    # a repeated type is mangled as a substitution (S1_ for the second bf16)
    m = re.search(r"rmnp_kernelILi(\d+)ELb(\d)ELb(\d)E((?:f|13__nv_bfloat16|S\d*_)+)E", mangled)
    if m is None:
        return mangled
    tv, tw = ("32" if t == "f" else "16"
              for t in re.findall(r"f|13__nv_bfloat16|S\d*_", m.group(4)))
    form = "apply" if m.group(2) == "1" else "precondition"
    path = "one_read" if m.group(3) == "1" else "two_sweep"
    return f"C{m.group(1)}_{form}_{path}_v{tv}" + (f"_w{tw}" if form == "apply" else "")


def phase_rmnp():
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.roofline import HBM_BW, rmnp_bytes
    from repro_torch.kernels import report as kreport
    from repro_torch.kernels import rmnp_update as rm
    gen = torch.Generator(device="cuda").manual_seed(0)
    beta, eps = 0.95, 1e-8
    # Each output element is held at atol_frac * max|want| + rtol * |want|.
    # fp32: the kernel sums squares in another order (its own fixed order,
    # csrc/rmnp_update.cu), a few fp32 ulps, so rtol 1e-5. bf16: both sides round
    # nearly equal fp32 values once; where a value straddles a rounding
    # boundary they differ by one bf16 step, at most 2^-7 of the element.
    # atol_frac 1e-6 covers values that cancel to near 0 (the EMA's terms
    # are ~2^-24 off in fp32). The weight update of a bf16 weight is mostly
    # below one bf16 step, so the fp32-weight runs also hold the update
    # itself, w_new - w, at 1e-3 of its largest value: w_new - w is exact to
    # an fp32 ulp of w (~1e-8), the update is ~1e-4, and a kernel that drops
    # it, flips its sign or normalizes over d_out misses it by its own size.
    rtol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
    update_rtol = 1e-3
    kernels = {
        "rmnp_apply": (
            lambda g, v, w, sc: rm.rmnp_rownorm_apply(g, v, w, sc, beta=beta, eps=eps),
            lambda g, v, w, sc: rm.rmnp_rownorm_apply_plain(g, v, w, sc, beta=beta, eps=eps),
            True),
        "rmnp_precondition": (
            lambda g, v, w, sc: rm.rmnp_rownorm(g, v, beta=beta, eps=eps),
            lambda g, v, w, sc: rm.rmnp_rownorm_plain(g, v, beta=beta, eps=eps),
            False),
    }
    # (momentum, weights): the main path's types, bf16 momentum, and fp32
    # weights for the update check (the precondition kernel reads no weights)
    combos = [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16),
              (torch.float32, torch.float32)]
    rows, bitwise = {name: [] for name in kernels}, []
    summary = {name: {"max_abs_err": 0.0, "worst_ratio": 0.0, "ms": 0.0,
                      "plain_ms": 0.0, "bound_ms": 0.0,
                      **{other: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                                 "max_abs_err": 0.0}
                    for other in ("llama", "deepseek", "xlstm", "jamba", "paligemma",
                                  "yi", "olmoe")}}
               for name in kernels}
    others = {"llama-130m": "llama", "deepseek-v2-lite-16b-3L": "deepseek",
              "xlstm-350m-12L": "xlstm", "jamba-v0.1-52b-2L": "jamba",
              "paligemma-3b-embedding": "paligemma", "yi-9b-2L": "yi",
              "olmoe-1b-7b-2L": "olmoe"}
    for model, shape in ([("gpt2-small", b) for b in BUCKETS]
                         + [("llama-130m", b) for b in LLAMA_BUCKETS]
                         + [("deepseek-v2-lite-16b-3L", b) for b in DS_BUCKETS]
                         + [("xlstm-350m-12L", b) for b in XLSTM_BUCKETS]
                         + [("jamba-v0.1-52b-2L", b) for b in J2_BUCKETS]
                         + [("paligemma-3b-embedding", P_BUCKETS[0])]
                         + [("yi-9b-2L", b) for b in YI_BUCKETS]
                         + [("olmoe-1b-7b-2L", b) for b in O_BUCKETS]):
        layout = rm.split(*shape[1:])
        path = "one-read" if layout.one_read else "two-sweep"
        # every bucket on the one-read path but paligemma's embedding, whose
        # 257280-row slab exceeds a 16-block cluster's shared memory even
        # at 8 columns (rm.split): it must take the two-sweep path
        check(layout.one_read == (model != "paligemma-3b-embedding"),
              f"rmnp {shape}: split {layout} takes the {path} path")
        full_checks = math.prod(shape) <= A_FULL_CHECKS_MAX
        for vdt, wdt in (combos if full_checks else combos[:1]):
            g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
            v = (torch.randn(shape, generator=gen, device="cuda") * 1e-3).to(vdt)
            w = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(wdt)
            scalars = torch.tensor([2e-3 * max(1.0, (shape[2] / shape[1]) ** 0.5), 0.1],
                                   device="cuda")
            vb, wb = v.element_size(), w.element_size()
            for name, (kernel, plain, apply) in kernels.items():
                if not apply and wdt == torch.float32:
                    continue
                # the plain version first: its fp32 temporaries are the
                # phase's largest (five copies of jamba's 2.0 G-element stack)
                want = plain(g, v, w, scalars)
                got = kernel(g, v, w, scalars)
                torch.cuda.synchronize()
                rec = {"model": model, "shape": list(shape),
                       "momentum": str(vdt).split(".")[1], "weights": str(wdt).split(".")[1]}
                err, ratio = 0.0, 0.0
                for out, a, b in zip(("v", "w" if apply else "d"), got, want, strict=True):
                    check(torch.isfinite(a.float()).all().item(),
                          f"{name} {out} {shape} not finite")
                    e, r = elementwise_err(a, b, rtol[a.dtype])
                    rec[f"{out}_max_abs_err"], rec[f"{out}_worst_ratio"] = e, r
                    check(r <= 1.0, f"{name} {out} {shape} {vdt} {wdt}: max_abs_err {e}, "
                                    f"worst ratio to the limit {r} > 1")
                    err, ratio = max(err, e), max(ratio, r)
                if apply and wdt == torch.float32:
                    u_got, u_want = got[1] - w, want[1] - w
                    e = max_err(u_got, u_want)
                    lim = update_rtol * float(u_want.abs().max())
                    rec.update(update_max_abs_err=e, update_max=float(u_want.abs().max()),
                               update_tolerance=lim)
                    check(e <= lim, f"{name} update {shape}: max_abs_err {e} > {lim}")
                    del u_got, u_want
                del got, want
                nbytes = rmnp_bytes(shape, vb, wb, apply)
                clusters = rm.max_active_clusters(shape, vdt, wdt, apply=apply)
                check(clusters > 0, f"{name} {shape}: no cluster of {layout} fits the card")
                rec.update(max_abs_err=err, worst_ratio=ratio,
                           kernel_ms=time_ms(lambda: kernel(g, v, w, scalars)),
                           plain_ms=time_ms(lambda: plain(g, v, w, scalars)),
                           bound_ms=nbytes / HBM_BW * 1e3, bound_by="bytes",
                           split=layout._asdict(), path=path, clusters_at_once=clusters)
                rec["gb_s"] = nbytes / rec["kernel_ms"] / 1e6
                rows[name].append(rec)
                print(f"{name} {model} {'x'.join(map(str, shape))} v {rec['momentum']} w "
                      f"{rec['weights']}: {rec['kernel_ms']:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms, {rec['gb_s']:.0f} GB/s, plain "
                      f"{rec['plain_ms']:.4f} ms; K={layout.K} R={layout.R} C={layout.C} "
                      f"threads={layout.threads}, {path}, {clusters} clusters at once",
                      flush=True)
                if (vdt, wdt) == combos[0] and model in others:
                    s = summary[name][others[model]]
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    for k in ("ms", "plain_ms", "bound_ms"):
                        s[k] += rec["kernel_ms" if k == "ms" else k]
                elif (vdt, wdt) == combos[0]:  # the main path's types
                    s = summary[name]
                    s["max_abs_err"] = max(s["max_abs_err"], err)
                    s["worst_ratio"] = max(s["worst_ratio"], ratio)
                    s["ms"] += rec["kernel_ms"]
                    s["plain_ms"] += rec["plain_ms"]
                    s["bound_ms"] += rec["bound_ms"]
            del g, v, w
            torch.cuda.empty_cache()
        if full_checks:
            bitwise.append(dict(rmnp_bitwise(shape, gen, beta, eps), model=model))
    for name, recs in rows.items():
        emit(f"A_{name}", {"buckets": recs})
    ptxas = kreport.ptxas_lines(build.PTXAS_REPORTS.get("rmnp_update", ""), "rmnp_kernel", "",
                                key=rmnp_instantiation)
    check(len(ptxas) == 30, f"rmnp: {len(ptxas)} instantiations in the ptxas report, want 30")
    for key, line in sorted(ptxas.items()):
        print(f"ptxas rmnp_kernel {key}: {line}", flush=True)
    emit("A_rmnp_bitwise", {"buckets": bitwise, "ptxas": ptxas})
    return summary


def rmnp_bitwise(shape, gen, beta, eps):
    """Bit for bit at one bucket: a stacked launch against each slice
    launched alone (both forms; fp32 momentum, bf16 weights), and in fp32
    apply against precondition followed by the two-pass engine's eager ops
    (``-scale * (d + wd * w)``, then ``w + update``)."""
    import torch
    from repro_torch.kernels import rmnp_update as rm
    g = torch.randn(shape, generator=gen, device="cuda") * 1e-3
    v = torch.randn(shape, generator=gen, device="cuda") * 1e-3
    w = torch.randn(shape, generator=gen, device="cuda") * 0.02
    scalars = torch.tensor([2e-3, 0.1], device="cuda")
    w16 = w.to(torch.bfloat16)
    stacked = {"precondition": rm.rmnp_rownorm(g, v, beta=beta, eps=eps),
               "apply": rm.rmnp_rownorm_apply(g, v, w16, scalars, beta=beta, eps=eps)}
    slices = {"precondition": 0, "apply": 0}
    for i in range(shape[0]):
        one = {"precondition": rm.rmnp_rownorm(g[i:i + 1], v[i:i + 1], beta=beta, eps=eps),
               "apply": rm.rmnp_rownorm_apply(g[i:i + 1], v[i:i + 1], w16[i:i + 1], scalars,
                                              beta=beta, eps=eps)}
        for form, outs in one.items():
            slices[form] += all(torch.equal(a[i], b[0])
                                for a, b in zip(stacked[form], outs, strict=True))
    del stacked, w16
    v_apply, w_apply = rm.rmnp_rownorm_apply(g, v, w, scalars, beta=beta, eps=eps)
    v_pre, d = rm.rmnp_rownorm(g, v, beta=beta, eps=eps)
    two_pass = w + -scalars[0] * (d + 0.1 * w)
    rec = {"shape": list(shape), "slices_equal": slices, "slices": shape[0],
           "apply_v_equals_precondition_v": bool(torch.equal(v_apply, v_pre)),
           "apply_w_equals_two_pass_w": bool(torch.equal(w_apply, two_pass)),
           "apply_w_two_pass_max_abs_diff": max_err(w_apply, two_pass)}
    check(slices == {"precondition": shape[0], "apply": shape[0]},
          f"rmnp {shape}: a stacked launch differs from its slices {slices}")
    check(rec["apply_v_equals_precondition_v"] and rec["apply_w_equals_two_pass_w"],
          f"rmnp {shape}: apply differs from precondition + eager ops {rec}")
    return rec


# the fp32 kernel's wide builds, as (case tag, H, K, hd, hdv) at their
# models' heads: qwen3-4b (yi-9b, olmoe-1b-7b and jamba take the same
# build), phi3-mini-3.8b, minicpm3-4b's MLA, deepseek-v2-lite-16b's MLA and
# paligemma-3b
FP32_WIDE = [("qwen3_hd128", 32, 8, 128, 128), ("phi3_hd96", 32, 32, 96, 96),
             ("minicpm3_mla", 40, 40, 96, 64), ("deepseek_mla", 16, 16, 192, 128),
             ("paligemma_hd256", 8, 1, 256, 256)]


def exact_attention(q, k, v, causal):
    """Softmax attention in float64 (dense, kv head h // G), (B,S,H,hd)."""
    import torch
    G = q.shape[2] // k.shape[2]
    qd, kd, vd = (x.double().transpose(1, 2) for x in (q, k, v))
    kd, vd = kd.repeat_interleave(G, 1), vd.repeat_interleave(G, 1)
    s = qd @ kd.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool, device=q.device).triu(1),
                          float("-inf"))
    return (torch.softmax(s, -1) @ vd).transpose(1, 2)


def attention_inputs(gen, B, S, H, K, hd, dtype, hdv=None):
    """q (B,S,H,hd), k (B,S,K,hd), v (B,S,K,hdv). With hdv != hd, v is MLA's
    layout: the last hdv columns of a (B,S,K,hd_nope + hdv) tensor whose
    first columns are k's nope part (hd_nope = hdv here), a strided view."""
    import torch
    q, k = (torch.randn(B, S, h, hd, generator=gen, device="cuda").to(dtype) for h in (H, K))
    if hdv is None or hdv == hd:
        return [q, k, torch.randn(B, S, K, hd, generator=gen, device="cuda").to(dtype)]
    kv = torch.randn(B, S, K, 2 * hdv, generator=gen, device="cuda").to(dtype)
    return [q, k, kv[..., hdv:]]


def phase_attention():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import build
    from repro_torch.launch.roofline import PEAK_FLOPS_BF16, attention_bounds, attention_flops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import report as kreport
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, fp32 = torch.bfloat16, torch.float32
    # (name, B, S, H, K, hd, dtype, causal, timed[, hdv]): in each type the main
    # path's shape causal and not, GQA with a ragged S causal and not, hd 32
    # and 16 with G = 4, and ragged S around the 64-key tile and the 128-row
    # query tile; timed: bf16 at the main shape causal and not and at the
    # GQA shape, fp32 at the main shape and at the GQA shape (row 3f)
    cases = [("main", 8, 1024, 12, 12, 64, bf16, True, True),
             ("main_noncausal", 8, 1024, 12, 12, 64, bf16, False, True),
             ("gqa_ragged", 2, 1000, 8, 2, 64, bf16, True, True),
             ("gqa_ragged_fp32", 2, 1000, 8, 2, 64, fp32, True, True),
             ("gqa_ragged_noncausal", 2, 1000, 8, 2, 64, bf16, False, False),
             ("hd32_g4", 2, 1024, 8, 2, 32, bf16, True, False),
             ("hd16_g4", 2, 1024, 8, 2, 16, bf16, True, False)]
    cases += [(f"s{S}", 2, S, 8, 2, 64, bf16, True, False) for S in (1, 63, 65, 129)]
    # bf16 at hd 128: qwen3-4b's prefill shape causal (timed, row 3 hd 128)
    # and not, a ragged GQA S causal and not, and S around the tiles' edges
    cases += [("qwen3_hd128", 8, 1024, 32, 8, 128, bf16, True, True),
              ("qwen3_hd128_noncausal", 8, 1024, 32, 8, 128, bf16, False, False),
              ("gqa_ragged_hd128", 2, 1000, 8, 2, 128, bf16, True, False),
              ("gqa_ragged_hd128_noncausal", 2, 1000, 8, 2, 128, bf16, False, False)]
    cases += [(f"s{S}_hd128", 2, S, 8, 2, 128, bf16, True, False) for S in (1, 63, 65, 129)]
    # bf16 at hd 128 at two more GQA groups: yi-9b's prefill shape (H = 32 on
    # K = 4, G = 8) and olmoe-1b-7b's (H = K = 16, G = 1), each causal (timed)
    # and not
    cases += [("yi_hd128", 8, 1024, 32, 4, 128, bf16, True, True),
              ("yi_hd128_noncausal", 8, 1024, 32, 4, 128, bf16, False, False),
              ("olmoe_hd128", 8, 1024, 16, 16, 128, bf16, True, True),
              ("olmoe_hd128_noncausal", 8, 1024, 16, 16, 128, bf16, False, False)]
    # bf16 at MLA's head dims, q/k 192 and v 128 (v a strided column slice,
    # as MLA's): deepseek-v2-lite's prefill shape causal (timed, row 3 at
    # (192, 128)) and not, a ragged S causal and not, S around the tiles' edges
    cases += [("deepseek_mla", 8, 1024, 16, 16, 192, bf16, True, True, 128),
              ("deepseek_mla_noncausal", 8, 1024, 16, 16, 192, bf16, False, False, 128),
              ("ragged_mla", 2, 1000, 16, 16, 192, bf16, True, False, 128),
              ("ragged_mla_noncausal", 2, 1000, 16, 16, 192, bf16, False, False, 128)]
    cases += [(f"s{S}_mla", 2, S, 16, 16, 192, bf16, True, False, 128)
              for S in (1, 63, 65, 129)]
    # bf16 at hd 256, paligemma-3b's heads (H = 8 on K = 1): its prefill
    # shape causal (timed, row 3 hd 256) and not, the ragged S (timed), and S
    # around the tiles' edges
    cases += [("paligemma_hd256", 8, 1024, 8, 1, 256, bf16, True, True),
              ("paligemma_hd256_noncausal", 8, 1024, 8, 1, 256, bf16, False, False),
              ("ragged_hd256", 2, 1000, 8, 1, 256, bf16, True, True)]
    cases += [(f"s{S}_hd256", 2, S, 8, 1, 256, bf16, True, False) for S in (1, 63, 65, 129)]
    # bf16 at hd 96 (three 32-column sub-tiles under the 64-byte swizzle):
    # phi3-mini-3.8b's (96, 96) and minicpm3-4b's MLA (96, 64), v a strided
    # column slice: each prefill shape causal (timed, rows 3 (96, 96) and (96,
    # 64)) and not, a ragged S=1000 causal and not, and S around the tiles'
    # edges
    for tag, H, hdv in (("phi3_hd96", 32, 96), ("minicpm3_mla", 40, 64)):
        cases += [(tag, 8, 1024, H, H, 96, bf16, True, True, hdv),
                  (f"{tag}_noncausal", 8, 1024, H, H, 96, bf16, False, False, hdv),
                  (f"ragged_{tag}", 2, 1000, H, H, 96, bf16, True, False, hdv),
                  (f"ragged_{tag}_noncausal", 2, 1000, H, H, 96, bf16, False, False, hdv)]
        cases += [(f"s{S}_{tag}", 2, S, 8, 8, 96, bf16, True, False, hdv)
                  for S in (1, 63, 65, 129)]
    cases += [("main_fp32", 8, 1024, 12, 12, 64, fp32, True, True),
              ("main_fp32_noncausal", 8, 1024, 12, 12, 64, fp32, False, False),
              ("gqa_ragged_fp32_noncausal", 2, 1000, 8, 2, 64, fp32, False, False),
              ("hd32_g4_fp32", 2, 1024, 8, 2, 32, fp32, True, False),
              ("hd16_g4_fp32", 2, 1024, 8, 2, 16, fp32, True, False)]
    cases += [(f"s{S}_fp32", 2, S, 8, 2, 64, fp32, True, False) for S in (1, 63, 65, 129)]
    # fp32 at each wide build (FP32_WIDE): the model's prefill shape
    # causal (timed, a row 3f) and not, a ragged S=1000 causal and not, and
    # S around the 64-key tile and the 64- and 128-row query tiles
    for tag, H, K, hd, hdv in FP32_WIDE:
        cases += [(f"{tag}_fp32", 8, 1024, H, K, hd, fp32, True, True, hdv),
                  (f"{tag}_fp32_noncausal", 8, 1024, H, K, hd, fp32, False, False, hdv),
                  (f"ragged_{tag}_fp32", 2, 1000, H, K, hd, fp32, True, False, hdv),
                  (f"ragged_{tag}_fp32_noncausal", 2, 1000, H, K, hd, fp32, False, False, hdv)]
        cases += [(f"s{S}_{tag}_fp32", 2, S, 8, max(1, 8 * K // H), hd, fp32, True, False, hdv)
                  for S in (1, 63, 65, 129)]
    # Each output element is held at 1e-6 * max|want| + rtol * |want|
    # (elementwise_err). fp32: the plain version sums fp32 products, the
    # kernel 3xTF32 products (to about 2^-22 each) in its own order, and
    # both agree to a few fp32 ulps of each element: rtol 1e-5. bf16: both
    # compute in fp32 (the kernel keeps p to fp32 accuracy in three bf16
    # parts) and round once; where a value straddles a rounding boundary they
    # differ by one bf16 step, at most 2^-7 of the element.
    rtol = {bf16: 2.0 ** -7, fp32: 1e-5}
    rows, inputs = [], {}
    for name, B, S, H, K, hd, dt, causal, timed, *rest in cases:
        hdv = rest[0] if rest else hd
        q, k, v = attention_inputs(gen, B, S, H, K, hd, dt, hdv)
        inputs[name] = (q, k, v, causal)
        out = fa.flash_attention_fwd_kernel(q, k, v, causal=causal)
        ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                           block_q=min(512, S), block_k=min(512, S))
        torch.cuda.synchronize()
        e, ratio = elementwise_err(out, ref, rtol[dt])
        check(out.shape == (B, S, H, hdv) and torch.isfinite(out.float()).all().item(),
              f"attention {name}: bad output")
        check(ratio <= 1.0, f"attention {name}: max_abs_err {e}, worst ratio {ratio} > 1")
        rec = {"case": name, "B": B, "S": S, "H": H, "K": K, "hd": hd, "hdv": hdv,
               "dtype": str(dt).split(".")[1], "causal": causal, "max_abs_err": e,
               "worst_ratio": ratio}
        if hdv != hd:  # the strided v, the kernel's input, against a contiguous copy
            rec["v_strides"] = list(v.stride())
            again = fa.flash_attention_fwd_kernel(q, k, v.contiguous(), causal=causal)
            check(torch.equal(again, out), f"attention {name}: a contiguous v changes bits")
            del again
        if dt == fp32:
            # also against a float64 softmax, so that a miss is assigned to
            # the kernel or to the plain version
            exact = exact_attention(q, k, v, causal)
            rec["worst_ratio_float64"] = elementwise_err(out, exact, rtol[dt])[1]
            rec["plain_worst_ratio_float64"] = elementwise_err(ref, exact, rtol[dt])[1]
            check(rec["worst_ratio_float64"] <= 1.0,
                  f"attention {name}: against float64, worst ratio "
                  f"{rec['worst_ratio_float64']} > 1")
            del exact
        del out, ref
        if timed:
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            rec.update(
                kernel_ms=time_ms(lambda: fa.flash_attention_fwd_kernel(q, k, v, causal=causal)),
                plain_ms=time_ms(lambda: fa.flash_attention_fwd_plain(
                    q, k, v, causal=causal, block_q=min(512, S), block_k=min(512, S)), iters=3))
            try:  # the yardstick; SDPA may take no hdv != hd on this build
                rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=K != H))
            except RuntimeError as err:
                rec["library_ms"], rec["library_error"] = None, str(err)[:200]
            del qt, kt, vt
            bound, by, ffma = attention_bounds(B, S, H, K, hd, dt, causal, hdv)
            rec.update(bound_ms=bound, bound_by=by)
            if ffma is not None:
                rec["bound_ffma_ms"] = ffma
            else:
                # the kernel's own floor: P.V as three bf16 products
                rec["flops"] = attention_flops(B, S, H, hd, causal, hdv)
                rec["flops_three_part"] = attention_flops(B, S, H, hd, causal, hdv, pv_parts=3)
                rec["bound_three_part_ms"] = max(bound,
                                                 rec["flops_three_part"] / PEAK_FLOPS_BF16 * 1e3)
            rec["tflops"] = attention_flops(B, S, H, hd, causal, hdv) / rec["kernel_ms"] / 1e9
            print(f"attention {name}: {rec['kernel_ms']:.4f} ms, bound {bound:.4f} ms ({by})"
                  + (f", FFMA bound {ffma:.4f} ms" if ffma is not None else "")
                  + f", SDPA {rec['library_ms']} ms, plain {rec['plain_ms']:.4f} ms",
                  flush=True)
        rows.append(rec)

    # two launches on the same input give the same bits (no atomics)
    for name in ("main", "main_fp32", "qwen3_hd128", "yi_hd128", "olmoe_hd128",
                 "deepseek_mla", "paligemma_hd256", "phi3_hd96", "minicpm3_mla",
                 *(f"{w[0]}_fp32" for w in FP32_WIDE)):
        q, k, v, causal = inputs[name]
        a = fa.flash_attention_fwd_kernel(q, k, v)
        b = fa.flash_attention_fwd_kernel(q, k, v)
        check(torch.equal(a, b), f"attention: two launches on the {name} input differ")
        del a, b

    # Near-zero elements of non-causal rows over ~1000 keys are where P's
    # precision (bf16) and the 3xTF32 sums (fp32) show: one head config,
    # many seeds, every element of every seed held at the limit. bf16 is
    # held against the plain version, whose fp32 error is far below a bf16
    # step. fp32 is held against a float64 softmax: there the plain
    # version's own fp32 error reaches 0.93-0.96 of the limit on near-zero
    # elements (PERF.md, PR 17), so a reading against it measures the plain
    # version; the kernel's reading against the plain version is reported
    # beside it.
    def seeds_over_limit(dt, n=40, hd=64, hdv=None, kv_heads=1):
        over, worst, ratios = 0, 0.0, []
        g = torch.Generator(device="cuda").manual_seed(3)
        for _ in range(n):
            q, k, v = attention_inputs(g, 1, 1000, 4, kv_heads, hd, dt, hdv)
            got = fa.flash_attention_fwd_kernel(q, k, v, causal=False)
            want = fa.flash_attention_fwd_plain(q, k, v, causal=False)
            if dt == fp32:
                exact = exact_attention(q, k, v, causal=False)
                ratios.append({"kernel_float64": elementwise_err(got, exact, rtol[dt])[1],
                               "plain_float64": elementwise_err(want, exact, rtol[dt])[1],
                               "kernel_plain": elementwise_err(got, want, rtol[dt])[1]})
                r = ratios[-1]["kernel_float64"]
            else:
                r = elementwise_err(got, want, rtol[dt])[1]
            over, worst = over + (r > 1.0), max(worst, r)
        out = {"seeds": n, "reference": "float64" if dt == fp32 else "plain",
               "over_limit": over, "worst_ratio": worst}
        if ratios:
            out.update({f"worst_{k}": max(r[k] for r in ratios) for k in ratios[0]})
            out["per_seed"] = ratios
        return out

    stress = {"bf16": seeds_over_limit(bf16), "fp32": seeds_over_limit(fp32),
              "bf16_hd128": seeds_over_limit(bf16, n=20, hd=128),
              "bf16_hd192_hdv128": seeds_over_limit(bf16, n=20, hd=192, hdv=128, kv_heads=4),
              "bf16_hd256": seeds_over_limit(bf16, n=20, hd=256, kv_heads=1)}
    # 10 seeds of each fp32 wide build, its models' kv grouping (at most
    # G = 4 on the 4 heads of the sweep's shape)
    for tag, H, K, hd, hdv in FP32_WIDE:
        stress[f"fp32_{tag}"] = seeds_over_limit(fp32, n=10, hd=hd, hdv=hdv,
                                                 kv_heads=max(1, 4 * K // H))
    check(all(r["over_limit"] == 0 for r in stress.values()),
          f"attention: the non-causal seed sweep missed the limit {stress}")
    # 20 seeds of a prefill shape, every element of each held at the limit:
    # hd 256 at paligemma's (B=8, S=1024, H=8, K=1, causal); hd 96 at
    # phi3-mini's (H=K=32) and minicpm3's MLA (H=K=40, v 64, strided),
    # causal and not
    def prefill_seeds(key, H, K, hd, causal, seed, hdv=None):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ratios = []
        for _ in range(20):
            q, k, v = attention_inputs(g, 8, 1024, H, K, hd, bf16, hdv)
            got = fa.flash_attention_fwd_kernel(q, k, v, causal=causal)
            ratios.append(elementwise_err(
                got, fa.flash_attention_fwd_plain(q, k, v, causal=causal), rtol[bf16])[1])
        stress[key] = {"seeds": 20, "reference": "plain", "causal": causal,
                       "over_limit": sum(r > 1.0 for r in ratios), "worst_ratio": max(ratios)}
        check(stress[key]["over_limit"] == 0,
              f"attention: {key} missed the limit over 20 seeds {ratios}")

    prefill_seeds("bf16_hd256_paligemma_prefill", 8, 1, 256, True, 4)
    # hd 128 at yi-9b's (G = 8) and olmoe-1b-7b's (G = 1), causal and not
    for seed, (key, H, K) in enumerate((("yi_hd128", 32, 4), ("olmoe_hd128", 16, 16))):
        for causal in (True, False):
            prefill_seeds(f"bf16_{key}_prefill" + ("" if causal else "_noncausal"), H, K,
                          128, causal, 9 + 2 * seed + (not causal))
    for seed, (key, H, hdv) in enumerate((("phi3_hd96", 32, 96), ("minicpm3_mla", 40, 64))):
        for causal in (True, False):
            prefill_seeds(f"bf16_{key}_prefill" + ("" if causal else "_noncausal"), H, H, 96,
                          causal, 5 + 2 * seed + (not causal), hdv)
    ptxas, hgmma = {}, {}
    for lib, kernel, dt in (("flash_attention_fwd", "fa_fwd_tc", bf16),
                            ("flash_attention_fwd_tf32", "fa_fwd_tf32_kernel", fp32)):
        lines = kreport.ptxas_lines(build.PTXAS_REPORTS.get(lib, ""), kernel, "hd")
        counts = kreport.sass_counts(build.library_path(lib))
        ours = {n: c for n, c in counts.items() if n.startswith(kernel)}
        # both kernels are templates over (hd, hdv)
        keys = [f"{hd}_{hdv}" for hd, hdv in fa.HEAD_DIM_PAIRS[dt]]
        check(len(ours) == len(keys) and all(c > 0 for c in ours.values())
              and all(f"{kernel}_{key}" in ours for key in keys),
              f"attention: HGMMA missing from {kernel}'s SASS: {counts}")
        check(all(f"hd{key}" in lines for key in keys),
              f"attention: no ptxas line for each of {kernel}'s head dims: {lines}")
        for key, line in lines.items():
            print(f"ptxas {kernel} {key}: {line}", flush=True)
        ptxas[kernel], hgmma[kernel] = lines, ours
    # the bf16 kernel's design: a producer warpgroup that gives its registers
    # to the consumers (setmaxnreg in the SASS), no build that spills, and
    # no wgmma that ptxas serialised
    report = build.PTXAS_REPORTS.get("flash_attention_fwd", "")
    design = kreport.flash_design(
        report, kreport.sass_functions(build.library_path("flash_attention_fwd")), "fa_fwd_tc")
    serialized = kreport.wgmma_serialized(report)
    for key, d in design.items():
        print(f"bf16 flash {key}: {d['registers']} registers, {d['spill_stores']} bytes spill "
              f"stores, {d['spill_loads']} bytes spill loads, {d['usetmaxreg']} USETMAXREG, "
              f"{d['hgmma']} HGMMA", flush=True)
    check(all(d["spill_stores"] == 0 and d["spill_loads"] == 0 for d in design.values()),
          f"attention: a bf16 flash build spills {design}")
    check(all(d["usetmaxreg"] > 0 and d["hgmma"] > 0 for d in design.values()),
          f"attention: USETMAXREG or HGMMA missing from fa_fwd_tc's SASS {design}")
    check(not serialized, f"attention: ptxas serialised the bf16 kernel's wgmma {serialized}")
    # every fp32 build: HGMMA (3xTF32 on wgmma) and no spill; the builds
    # with two consumer warpgroups hold USETMAXREG (reported, not required:
    # hd 256's one consumer takes none)
    fp32_design = kreport.flash_design(
        build.PTXAS_REPORTS.get("flash_attention_fwd_tf32", ""),
        kreport.sass_functions(build.library_path("flash_attention_fwd_tf32")),
        "fa_fwd_tf32_kernel")
    for key, d in fp32_design.items():
        print(f"fp32 flash {key}: {d['registers']} registers, {d['spill_stores']} bytes spill "
              f"stores, {d['spill_loads']} bytes spill loads, {d['usetmaxreg']} USETMAXREG, "
              f"{d['hgmma']} HGMMA", flush=True)
    check(sorted(fp32_design) == sorted(f"hd{hd}_{hdv}" for hd, hdv in fa.HEAD_DIM_PAIRS[fp32])
          and all(d["spill_stores"] == 0 and d["spill_loads"] == 0 and d["hgmma"] > 0
                  for d in fp32_design.values()),
          f"attention: an fp32 flash build spills or lacks HGMMA {fp32_design}")
    emit("B_attention", {"cases": rows, "noncausal_seeds": stress, "ptxas": ptxas,
                         "hgmma": hgmma, "bf16_design": design, "fp32_design": fp32_design})
    del inputs
    torch.cuda.empty_cache()
    return {r["case"]: r for r in rows}


def phase_ns():
    """The GEMM kernel in its three Newton-Schulz launches, each against a
    float64 product on the card, with a mutation control; five iterations
    kernel against plain; ns_step3 against ns_step slice by slice; times."""
    import torch
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import newton_schulz as nsk
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import gemm_bound, gemm_reads
    a, b, c = NS_COEFFS
    gen = torch.Generator(device="cuda").manual_seed(2)

    def normalized(shape):
        x = torch.randn(shape, generator=gen, device="cuda")
        return x / (torch.linalg.vector_norm(x, dim=(-2, -1), keepdim=True) + 1e-7)

    def launches(x):
        """(name, kernel, plain, library, float64 reference, reads) of the
        three launch kinds, each fed exact fp32 inputs (the float64 results
        of the launch before, rounded once)."""
        L, m, n = x.shape
        x64 = x.double()
        g64 = x64 @ x64.transpose(1, 2)
        g = g64.float()
        g64 = g.double()
        p64 = b * g64 + c * (g64 @ g64)
        p = p64.float()
        p64 = p.double()
        xt = x.transpose(1, 2)
        return [
            ("gram", lambda: mm.gemm(x, xt), lambda: nsk.gram_plain(x),
             lambda: torch.bmm(x, xt), x64 @ x64.transpose(1, 2), (L, m, m, n), gemm_reads(x, xt)),
            ("poly", lambda: mm.gemm(g, g, g, alpha=c, beta=b),
             lambda: nsk.poly_plain(g, b, c),
             lambda: torch.baddbmm(g, g, g, beta=b, alpha=c), p64, (L, m, m, m), gemm_reads(g, g, g)),
            ("apply", lambda: mm.gemm(p, x, x, alpha=1.0, beta=a),
             lambda: nsk.apply_plain(p, x, a),
             lambda: torch.baddbmm(x, p, x, beta=a), a * x64 + p64 @ x64, (L, m, n, m),
             gemm_reads(p, x, x)),
        ]

    def held(name, shape, kernel, plain, want, record):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        check(got.shape == want.shape and torch.isfinite(got).all().item(),
              f"{name} {shape}: bad output")
        e_k = float((got.double() - want).abs().max())
        e_p = float((ref.double() - want).abs().max())
        record.update(kernel_err64=e_k, plain_err64=e_p, max_abs_err=max_err(got, ref),
                      err_ratio=e_k / max(e_p, 1e-30))
        check(e_k <= E_ERR_FACTOR * e_p,
              f"{name} {shape}: kernel error {e_k} > {E_ERR_FACTOR} x plain error {e_p}")
        return got

    rows, per_kind = [], {}
    for shape in NS_BUCKETS + [(3, 100, 300)]:
        L, m, n = shape
        x = normalized(shape)
        for name, kernel, plain, library, want, (Lb, M, N, K), reads in launches(x):
            rec = {"kind": name, "shape": list(shape)}
            held(name, shape, kernel, plain, want, rec)
            if shape == (3, 100, 300):
                rows.append(rec)
                continue
            bound, by, ffma = gemm_bound(Lb, M, N, K, reads)
            rec.update(ms=time_ms(kernel), plain_ms=time_ms(plain, iters=3),
                       library_ms=time_ms(library), bound_ms=bound, bound_by=by,
                       bound_ffma_ms=ffma)
            rows.append(rec)
            per_kind.setdefault(name, []).append(rec)
            del want
        # mutation control: the Gram with its last k-tile of 8 skipped must fail
        if shape == NS_BUCKETS[0]:
            want = x.double() @ x.double().transpose(1, 2)
            try:
                held("gram-skipped-k-tile", shape,
                     lambda: mm.gemm(x[..., :-8], x[..., :-8].transpose(1, 2)),
                     lambda: nsk.gram_plain(x), want, {})
            except AssertionError as exc:
                control = str(exc)
            else:
                raise AssertionError("the mutation control (a skipped k-tile) passed the check")
            del want
        # five iterations, kernel against plain, and the stack against its slices
        yk = yp = x
        for _ in range(5):
            yk, yp = ops.ns_step(yk, a, b, c), nsk.ns_step3_plain(yp, a, b, c)
        rel = float(torch.linalg.vector_norm(yk - yp) / torch.linalg.vector_norm(yp))
        one = nsk.ns_step3(x, a, b, c)
        same = all(torch.equal(one[i], nsk.ns_step(x[i], a, b, c)) for i in {0, L - 1})
        rows.append({"kind": "newton_schulz_5", "shape": list(shape), "rel_frobenius": rel,
                     "tolerance": NS_REL_TOL, "stack_equals_slices": same})
        check(rel <= NS_REL_TOL, f"newton_schulz {shape}: relative distance {rel} > {NS_REL_TOL}")
        check(same, f"ns_step3 {shape}: a slice differs from ns_step on that slice")
        del x, yk, yp, one
        torch.cuda.empty_cache()

    # the 2-D path on the transposed side: rows > cols goes through X^T
    from repro_torch.core.muon import newton_schulz
    v = torch.randn(300, 100, generator=gen, device="cuda")
    got = newton_schulz(v)
    x = v.T / (torch.linalg.vector_norm(v) + 1e-7)
    for _ in range(5):
        x = nsk.ns_step_plain(x, a, b, c)
    rel = float(torch.linalg.vector_norm(got - x.T) / torch.linalg.vector_norm(x))
    rows.append({"kind": "newton_schulz_5_2d_transposed", "shape": [300, 100],
                 "rel_frobenius": rel, "tolerance": NS_REL_TOL})
    check(got.shape == v.shape and rel <= NS_REL_TOL,
          f"2-D transposed newton_schulz: relative distance {rel}")

    # the kernel's build: registers, spills and shared memory of each
    # instantiation, and wgmma (HGMMA) in the SASS of every one
    from repro_torch.kernels import build
    from repro_torch.kernels import report as kreport
    ptxas = kreport.ptxas_lines(build.PTXAS_REPORTS.get("matmul", ""), "gemm_kernel", "ab")
    hgmma = kreport.sass_counts(build.library_path("matmul"))
    gemms = {n: c for n, c in hgmma.items() if n.startswith("gemm_kernel")}
    check(len(gemms) == 4 and all(c > 0 for c in gemms.values()),
          f"GEMM: HGMMA missing from a kernel instantiation's SASS: {hgmma}")
    for key, line in ptxas.items():
        print(f"ptxas gemm_kernel {key}: {line}", flush=True)

    # The per-leaf engine runs the embedding leaf (50432, 768) through the 2-D
    # wrappers: the same launches as the L = 1 bucket (checked bit for bit
    # above, ns_step against ns_step3), so their rows take that bucket's times.
    emit("E_newton_schulz", {"launches": rows, "mutation_control": control,
                             "err_factor": E_ERR_FACTOR, "ptxas": ptxas, "hgmma": hgmma})

    def total(recs):
        out = {k: sum(r[k] for r in recs)
               for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        out["max_abs_err"] = max(r["max_abs_err"] for r in recs)
        out["bound_by"] = ("operations" if all(r["bound_by"] == "operations" for r in recs)
                           else "bytes")
        return out

    def embedding(recs):
        return [r for r in recs if r["shape"] == list(NS_BUCKETS[-1])]

    return {"matmul3": total(per_kind["gram"] + per_kind["apply"]),
            "ns_poly3": total(per_kind["poly"]),
            "matmul": total(embedding(per_kind["gram"] + per_kind["apply"])),
            "ns_poly": total(embedding(per_kind["poly"]))}


def phase_train():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.models import init_params, layers
    from repro_torch.models.model import forward
    from repro_torch.train.step import make_train_step

    main_launches = {}
    # C1: the main path, single-pass engine
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what phase V adds to its dry run
    t0 = time.time()
    params, state, hist = train("gpt2-small", reduced=False, optimizer="rmnp",
                                fused=True, fused_apply=True, use_kernel=True,
                                batch=8, seq=1024, steps=3, log_every=1)
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = dict(LAUNCHES)
    losses = [h["loss"] for h in hist]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    check([h["launches"]["rmnp_apply"] for h in hist] == [4, 4, 4],
          f"apply launches per step {[h['launches'] for h in hist]}")
    check(counts["rmnp_apply"] == 12, f"apply launches {counts}")
    main_launches["rmnp_apply"] = counts["rmnp_apply"]
    C1_FINAL.update(final=host_copy((params, state.buckets)),
                    step_s=step_seconds(hist),
                    peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    n_matrix = sum(b.numel() for b in state.buckets.values())
    buckets = {k: list(b.shape) for k, b in state.buckets.items()}
    check(sorted(buckets) == ["3072x768", "50432x768", "768x6144", "768x768"],
          f"buckets {buckets}")
    del params, state
    torch.cuda.empty_cache()
    # each step ends in a host read of its metrics, so the differences of the
    # cumulative wall clock are step times (step 0 includes first-use set-up)
    walls = [0.0] + [h["wall_s"] for h in hist]
    emit("C1_train_single_pass", {"losses": losses, "seconds": round(secs, 2),
                                  "step_s": [b - a for a, b in zip(walls, walls[1:])],
                                  "launches": counts, "buckets": buckets,
                                  "matrix_params": n_matrix,
                                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                                  "held_at_reset_gb": held / 2**30})

    # C2: the two-pass bucketed engine runs the precondition kernel
    reset_launches()
    _, _, hist2 = train("gpt2-small", reduced=False, optimizer="rmnp", fused=True,
                        fused_apply=False, use_kernel=True, batch=8, seq=1024,
                        steps=1, log_every=1)
    counts = dict(LAUNCHES)
    check(counts["rmnp_precondition"] == 4 and math.isfinite(hist2[0]["loss"]),
          f"bucketed step: launches {counts}, loss {hist2[0]['loss']}")
    main_launches["rmnp_precondition"] = counts["rmnp_precondition"]
    torch.cuda.empty_cache()
    emit("C2_train_bucketed", {"loss": hist2[0]["loss"], "launches": counts})

    # C3: attn_impl="pallas" against dense attention from the same init. At
    # init the loss (about ln 50432) hardly depends on attention, so the
    # final hidden state (after the last norm, O(1) values) is compared too,
    # by its relative Frobenius distance, and a control shows that the
    # comparison sees a wrong attention: the dense path made non-causal.
    base = get_config("gpt2-small")
    hidden, loss = {}, {}
    batch = batch_to_device(make_stream(base, 1024, 8, seed=0).sample(0), "cuda")
    dense_attention = layers.attention
    for run in ("auto", "pallas", "control"):
        cfg = dataclasses.replace(base, attn_impl="auto" if run == "control" else run)
        params = init_params(cfg, seed=0, device="cuda")
        if run == "control":
            layers.attention = lambda q, k, v, causal=True, **kw: dense_attention(
                q, k, v, False, **kw)
        try:
            with torch.no_grad():
                hidden[run] = forward(cfg, params, batch, return_hidden=True)[0].float()
        finally:
            layers.attention = dense_attention
        if run != "control":
            opt = make_optimizer("rmnp", dict(
                lr_matrix=cosine_with_warmup(2e-3, 3), lr_adamw=cosine_with_warmup(1e-3, 3),
                fused=True, fused_apply=True, use_kernel=True))
            state = opt.init(params)
            step_fn = make_train_step(cfg, opt, remat="full")
            reset_launches()
            params, state, metrics = step_fn(params, state, batch, 0)
            torch.cuda.synchronize()
            loss[run] = float(metrics["loss"])
            if run == "pallas":
                counts = dict(LAUNCHES)
            del state
        del params
        torch.cuda.empty_cache()

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    rel_flash = rel(hidden["pallas"], hidden["auto"])
    rel_control = rel(hidden["control"], hidden["auto"])
    diff = abs(loss["auto"] - loss["pallas"])
    emit("C3_train_flash", {"loss_dense": loss["auto"], "loss_flash": loss["pallas"],
                            "loss_abs_diff": diff, "loss_tolerance": C3_LOSS_TOL,
                            "hidden_rel_flash": rel_flash, "hidden_rel_control": rel_control,
                            "hidden_tolerance": C3_HIDDEN_TOL, "launches": counts})
    # 12 layers' forward, and each again when remat="full" recomputes it
    check(counts["flash_attention_fwd"] == 2 * base.num_layers, f"flash launches {counts}")
    check(math.isfinite(loss["pallas"]) and diff <= C3_LOSS_TOL,
          f"pallas loss {loss['pallas']} vs dense {loss['auto']}")
    check(rel_flash <= C3_HIDDEN_TOL, f"hidden state: flash {rel_flash} > {C3_HIDDEN_TOL}")
    check(rel_control >= 10 * C3_HIDDEN_TOL,
          f"hidden state: the non-causal control is only {rel_control} from dense, "
          f"less than 10x the tolerance {C3_HIDDEN_TOL}")
    main_launches["flash_attention_fwd"] = counts["flash_attention_fwd"]
    return main_launches


def train_flash_fp32(tag, base, steps, record):
    """One config in fp32 with attn_impl="pallas", the fp32 flash kernel on
    the main path, against dense attention from one init (seed 0, B=8,
    S=1024): the final hidden state (and a non-causal control), one
    single-pass RMNP step under remat="full" (a launch for each attention
    layer's forward and one for each that the stacked units recompute) and
    its loss, then ``steps - 1`` more steps of each, timed on the host clock
    (each ends in a host read of the loss), and peak memory. Emits
    ``record`` and returns the flash launches of the first step."""
    import torch
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import init_params, layers
    from repro_torch.models.model import forward, plan_stack
    from repro_torch.train.step import make_train_step

    base = dataclasses.replace(base, dtype="float32")
    # each attention layer's forward, and again in the recompute of the
    # stacked units (a prefix layer, deepseek's dense first one, is not
    # recomputed)
    attn = [m in ("gqa", "mla") for m, _ in base.pattern]
    want = sum(attn) + sum(attn[plan_stack(base.pattern)[0]:])
    batch = batch_to_device(make_stream(base, 1024, 8, seed=0).sample(0), "cuda")
    dense_attention = layers.attention
    hidden, loss, step_s, peak, counts = {}, {}, {}, {}, {}
    for run in ("auto", "pallas", "control"):
        cfg = dataclasses.replace(base, attn_impl="auto" if run == "control" else run)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, seed=0, device="cuda")
        if run == "control":
            layers.attention = lambda q, k, v, causal=True, **kw: dense_attention(
                q, k, v, False, **kw)
        try:
            with torch.no_grad():
                hidden[run] = forward(cfg, params, batch, return_hidden=True)[0].float()
        finally:
            layers.attention = dense_attention
        if run == "control":
            del params
            continue
        opt = make_optimizer("rmnp", dict(
            lr_matrix=cosine_with_warmup(2e-3, 4), lr_adamw=cosine_with_warmup(1e-3, 4),
            fused=True, fused_apply=True, use_kernel=True))
        state = opt.init(params)
        step_fn = make_train_step(cfg, opt, remat="full")
        secs = []
        for i in range(steps):
            torch.cuda.synchronize()
            if i == 0:
                reset_launches()
            t = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch, i)
            value = float(metrics["loss"])
            secs.append(time.perf_counter() - t)
            if i == 0:
                counts[run], loss[run] = dict(LAUNCHES), value
            check(math.isfinite(value), f"{tag} {run} step {i}: loss {value}")
        step_s[run] = secs
        peak[run] = torch.cuda.max_memory_allocated() / 2**30
        del params, state, opt, step_fn, metrics
        gc.collect()
    torch.cuda.empty_cache()

    def rel(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    rel_flash = rel(hidden["pallas"], hidden["auto"])
    rel_control = rel(hidden["control"], hidden["auto"])
    del hidden
    diff = abs(loss["auto"] - loss["pallas"])
    timing = {run: {"first_step_s": secs[0], "median_s": statistics.median(secs[1:]),
                    "min_s": min(secs[1:]), "max_s": max(secs[1:]), "step_s": secs}
              for run, secs in step_s.items()}
    emit(record, {
        "config": f"{base.name}, {base.num_layers} layers, full width, fp32, B=8, S=1024",
        "loss_dense": loss["auto"], "loss_flash": loss["pallas"], "loss_abs_diff": diff,
        "loss_tolerance": C3F_LOSS_TOL, "hidden_rel_flash": rel_flash,
        "hidden_rel_control": rel_control, "hidden_tolerance": C3F_HIDDEN_TOL,
        "launches": counts["pallas"], "steps": timing, "peak_mem_gb": peak})
    for run, t in timing.items():
        print(f"{tag} {run}: first step {t['first_step_s']:.3f} s, then median "
              f"{t['median_s']:.3f} s ({t['min_s']:.3f}-{t['max_s']:.3f}), peak "
              f"{peak[run]:.2f} GiB", flush=True)
    check(counts["pallas"]["flash_attention_fwd"] == want,
          f"{tag} flash launches {counts['pallas']}, want {want}")
    check(counts["auto"]["flash_attention_fwd"] == 0, f"{tag} dense launches {counts['auto']}")
    check(diff <= C3F_LOSS_TOL, f"{tag} pallas loss {loss['pallas']} vs dense {loss['auto']}")
    check(rel_flash <= C3F_HIDDEN_TOL,
          f"{tag} hidden state: flash {rel_flash} > {C3F_HIDDEN_TOL}")
    check(rel_control >= 10 * C3F_HIDDEN_TOL,
          f"{tag} hidden state: the non-causal control is only {rel_control} from dense, "
          f"less than 10x the tolerance {C3F_HIDDEN_TOL}")
    return counts["pallas"]["flash_attention_fwd"]


def phase_train_fp32():
    """C3f: gpt2-small at full width in fp32 (the fp32 flash kernel's hd-64
    build, 24 launches a step), 1 + 3 steps."""
    from repro_torch.configs import get_config
    return train_flash_fp32("C3f", get_config("gpt2-small"), 4, "C3f_train_flash_fp32")


def phase_train_fp32_wide():
    """T1: qwen3-4b cut to its first 2 layers at full width in fp32 through
    the fp32 kernel's (128, 128) build (4 launches a step; the build that
    qwen3-4b, yi-9b, olmoe-1b-7b and jamba take); T2: deepseek-v2-lite-16b
    cut to 3 layers (m1_config) through its (192, 128) build, v MLA's
    strided slice read in place (5 launches a step: its dense first layer
    is a prefix outside the recomputed stack). Each 1 + 2 steps, as
    C3f, under the allocator's expandable segments."""
    from repro_torch.configs import cut_layers, get_config
    out = {}
    with expandable_segments():
        out["T1"] = train_flash_fp32("T1", cut_layers(get_config(S_ARCH), "0:2"), T_STEPS,
                                     "T1_train_flash_fp32_qwen3_4b")
        out["T2"] = train_flash_fp32("T2", m1_config(), T_STEPS,
                                     "T2_train_flash_fp32_deepseek_v2_lite")
    return out


# Phase K, the launch census: the largest fp32 buffer the single-pass
# update may hold beside what it returns is one fp32 copy of the bucket it is
# on (the gathered gradient); a margin for the AdamW leaves' temporaries and
# the allocator's rounding
K_SCRATCH_MARGIN = 4 * 2 ** 20
# ... and the apply kernel alone: its outputs plus the [scale, wd] tensor,
# each as the caching allocator counts it (a large block is kept whole when
# less than 1 MiB of it would remain: 256 KiB on the embedding's momentum)
K_KERNEL_SLACK = 2 * 2 ** 20 + 4096
K_SECONDS = 30.0


def phase_census():
    """Phase K: what the tools predict on meta tensors against the card.

    At gpt2-small's full width (bf16, seed 0) four runs, each once under
    torch.profiler with the launch counts set to 0: a single-pass RMNP step
    (update_apply), a two-pass one (update), a bucketed Muon step
    (update_apply) and one forward with attn_impl="pallas" (B=8, S=1024).
    Per launch key the meta-traced count (introspect.collect_kernel_launches
    on meta copies of the same arguments; optimizer_launches for the
    optimizer steps), LAUNCHES and the profiler's kernel events must agree,
    and each event's instantiation, grid and block must equal the recorded
    launch's (kernels/census.py). optimizer_fp32_buffers at each bucket: the
    single-pass step holds 2 (the gathered fp32 gradient the kernel reads
    and the fp32 momentum it writes, no d and no update), the two-pass step
    more. The device peak during one update_apply, above what the step
    returns, stays within one fp32 copy of the largest bucket; the rise, the
    new values held beside the old ones (eager PyTorch donates nothing) and
    the two-pass update's scratch, the control, are printed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.core.types import map_with_path, tree_paths
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import census, introspect
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import init_params
    from repro_torch.models.model import forward
    from repro_torch.train.step import optimizer_fp32_buffers, optimizer_launches

    t0 = time.perf_counter()
    cfg = get_config("gpt2-small")
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    grads = map_with_path(lambda _p, x: (torch.randn(x.shape, generator=gen, device="cuda")
                                         * 1e-3).to(x.dtype), params)

    def build(rule, **kw):
        return make_optimizer(rule, dict(lr_matrix=cosine_with_warmup(2e-3, 3),
                                         lr_adamw=cosine_with_warmup(1e-3, 3), fused=True,
                                         **kw))
    single, two, muon = build("rmnp", fused_apply=True), build("rmnp"), build(
        "muon", fused_apply=True)
    cfg_flash = dataclasses.replace(cfg, attn_impl="pallas")
    batch = batch_to_device(make_stream(cfg, 1024, 8, seed=0).sample(0), "cuda")

    def forward_flash(p, b):
        with torch.no_grad():
            return forward(cfg_flash, p, b, return_hidden=True)[0]

    runs = {}
    for tag, opt, fn in (("rmnp_single_pass", single, "update_apply"),
                         ("rmnp_two_pass", two, "update"),
                         ("muon_bucketed", muon, "update_apply")):
        state = opt.init(params)
        step = getattr(opt, fn)
        args = (grads, state, params, 0)
        runs[tag] = (lambda step=step, args=args: step(*args), step, args,
                     optimizer_launches(opt, params))
    runs["forward_flash"] = (lambda: forward_flash(params, batch), forward_flash,
                             (params, batch), None)
    out = {}
    for tag, (run, fn, args, n_meta) in runs.items():
        run()  # the libraries are loaded; the census run is the second
        predicted = introspect.collect_kernel_launches(fn, *args)
        res = census.census(run, predicted)
        check(res["ok"], f"K {tag}: {res['mismatches'][:5]}")
        check(n_meta is None or n_meta == len(predicted),
              f"K {tag}: optimizer_launches {n_meta}, recorded {len(predicted)}")
        out[tag] = {"kernels": res["kernels"], "events": res["events"],
                    "smem": res["smem"],
                    "launches": [{"signature": r.signature, "grid": r.grid, "block": r.block,
                                  "cluster": r.cluster, "smem_bytes": r.smem_bytes}
                                 for r in dict.fromkeys(predicted)]}
        print(f"K {tag}: " + ", ".join(f"{k} meta/LAUNCHES/profiler {c['meta']}/"
                                      f"{c['launches']}/{c['profiler']}"
                                      for k, c in res["kernels"].items())
              + f"; shared memory (trace, recorded) {res['smem']}", flush=True)
    del runs
    check(out["rmnp_single_pass"]["kernels"]["rmnp_apply"]["meta"] == 4
          and out["rmnp_two_pass"]["kernels"]["rmnp_precondition"]["meta"] == 4
          and out["forward_flash"]["kernels"]["flash_attention_fwd"]["meta"] == cfg.num_layers,
          f"K launch counts {out}")

    buffers = {}
    for L, d_in, d_out in BUCKETS:
        one = optimizer_fp32_buffers(single, params, (L, d_in, d_out))
        many = optimizer_fp32_buffers(two, params, (L, d_in, d_out))
        buffers[f"{L}x{d_in}x{d_out}"] = {"single_pass": one, "two_pass": many}
        check(one == 2 and many > one, f"K fp32 buffers at {(L, d_in, d_out)}: single-pass "
                                       f"{one}, two-pass {many}")

    largest = 4 * max(math.prod(b) for b in BUCKETS)

    def scratch(opt, fn):
        state = opt.init(params)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        new = getattr(opt, fn)(grads, state, params, 0)
        torch.cuda.synchronize()
        peak, after = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
        old = {t.data_ptr(): t.numel() * t.element_size()
               for _, t in tree_paths((params, state)) if isinstance(t, torch.Tensor)}
        kept = {t.data_ptr() for _, t in tree_paths(new) if isinstance(t, torch.Tensor)}
        alive = sum(n for ptr, n in old.items() if ptr not in kept)
        del new, state
        return {"rise_bytes": peak - before, "held_bytes": after - before,
                "scratch_bytes": peak - after, "old_values_alive_bytes": alive}
    mem = {"single_pass": scratch(single, "update_apply"), "two_pass": scratch(two, "update"),
           "largest_bucket_fp32_bytes": largest}
    check(mem["single_pass"]["scratch_bytes"] <= largest + K_SCRATCH_MARGIN,
          f"K single-pass scratch {mem['single_pass']} above one fp32 copy of the largest "
          f"bucket ({largest} bytes)")
    check(mem["two_pass"]["scratch_bytes"] > largest + K_SCRATCH_MARGIN,
          f"K control: the two-pass update's scratch {mem['two_pass']} is within one fp32 "
          f"bucket; the check would not see a d bucket")
    # the apply kernel alone allocates its two outputs and nothing else: at
    # each bucket, on operands gathered beforehand, the peak rises by the
    # bytes of v_new and w_new (plus the 8-byte [scale, wd] tensor)
    from repro_torch.kernels import ops as kops
    kernel_rise = {}
    for L, d_in, d_out in BUCKETS:
        g = torch.randn((L, d_in, d_out), generator=gen, device="cuda")
        v = torch.zeros_like(g)
        w = torch.zeros((L, d_in, d_out), dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        v_new, w_new = kops.rmnp_bucket_update_apply(g, v, w, torch.tensor(1e-3), 0.1,
                                                     beta=0.95)
        torch.cuda.synchronize()
        outputs = v_new.numel() * 4 + w_new.numel() * 2
        rise = torch.cuda.max_memory_allocated() - before
        kernel_rise[f"{L}x{d_in}x{d_out}"] = {"rise_bytes": rise, "outputs_bytes": outputs}
        check(outputs <= rise <= outputs + K_KERNEL_SLACK,
              f"K apply kernel at {(L, d_in, d_out)}: peak rose {rise} bytes for "
              f"{outputs} bytes of outputs")
        del g, v, w, v_new, w_new
    mem["apply_kernel"] = kernel_rise
    print(f"K update_apply peak rise {mem['single_pass']['rise_bytes'] / 2**20:.1f} MiB, "
          f"scratch {mem['single_pass']['scratch_bytes'] / 2**20:.1f} MiB (limit "
          f"{largest / 2**20:.1f}), old values alive beside the new "
          f"{mem['single_pass']['old_values_alive_bytes'] / 2**20:.1f} MiB; two-pass "
          f"scratch {mem['two_pass']['scratch_bytes'] / 2**20:.1f} MiB", flush=True)
    del params, grads, single, two, muon
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    emit("K_census", {"runs": out, "fp32_buffers": buffers, "memory": mem,
                      "seconds": secs, "card": card_name()})
    check(secs <= K_SECONDS, f"K took {secs:.1f} s, more than {K_SECONDS}")
    return {tag: {k: c["launches"] for k, c in r["kernels"].items()} for tag, r in out.items()}


def phase_muon():
    """C4: Muon on the main path at full width, its per-leaf step, one
    bucketed step of each other rule, and the preconditioning time per step
    of RMNP against Muon."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, is_matrix_param, make_optimizer
    from repro_torch.core.types import map_with_path, tree_paths
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import train
    from repro_torch.models import init_params

    def ns_counts(counts):
        return {k: counts[k] for k in ("matmul", "matmul3", "ns_poly", "ns_poly3")}

    # 4 buckets x 5 iterations x (Gram + apply, polynomial)
    per_step = {"matmul": 0, "matmul3": 40, "ns_poly": 0, "ns_poly3": 20}
    main_launches = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    params, state, hist = train("gpt2-small", reduced=False, optimizer="muon", fused=True,
                                fused_apply=True, use_kernel=True, batch=8, seq=1024,
                                steps=3, log_every=1)
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = ns_counts(LAUNCHES)
    losses = [h["loss"] for h in hist]
    check(len(losses) == 3 and all(math.isfinite(x) for x in losses), f"muon losses {losses}")
    check(all(ns_counts(h["launches"]) == per_step for h in hist),
          f"muon launches per step {[ns_counts(h['launches']) for h in hist]}, "
          f"want {per_step}")
    main_launches.update(matmul3=counts["matmul3"], ns_poly3=counts["ns_poly3"])
    walls = [0.0] + [h["wall_s"] for h in hist]
    emit("C4_train_muon", {"losses": losses, "seconds": round(secs, 2),
                           "step_s": [b - a for a, b in zip(walls, walls[1:])],
                           "launches": counts, "launches_per_step": per_step,
                           "buckets": {k: list(b.shape) for k, b in state.buckets.items()},
                           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    del params, state
    torch.cuda.empty_cache()

    # the per-leaf engine: the 2-D embedding leaf through ns_step, each
    # stacked leaf through ns_step3
    reset_launches()
    params, _, hist = train("gpt2-small", reduced=False, optimizer="muon", fused=False,
                            fused_apply=False, use_kernel=True, batch=8, seq=1024, steps=1,
                            log_every=1)
    counts = ns_counts(LAUNCHES)
    mats = [t for p, t in tree_paths(params) if is_matrix_param(p, t)]
    n2, n3 = sum(t.ndim == 2 for t in mats), sum(t.ndim > 2 for t in mats)
    want = {"matmul": 10 * n2, "matmul3": 10 * n3, "ns_poly": 5 * n2, "ns_poly3": 5 * n3}
    check(n2 == 1 and counts == want and math.isfinite(hist[0]["loss"]),
          f"per-leaf muon: launches {counts}, want {want}; loss {hist[0]['loss']}")
    main_launches.update(matmul=counts["matmul"], ns_poly=counts["ns_poly"])
    rules = {"per_leaf_muon": {"loss": hist[0]["loss"], "launches": counts}}
    del params
    torch.cuda.empty_cache()

    # one bucketed step of each other rule; Nora launches no Newton-Schulz kernel
    for name in ("normuon", "muown", "nora"):
        reset_launches()
        _, state, hist = train("gpt2-small", reduced=False, optimizer=name, fused=True,
                               fused_apply=False, use_kernel=True, batch=8, seq=1024,
                               steps=1, log_every=1)
        counts = ns_counts(LAUNCHES)
        want = per_step if name != "nora" else dict.fromkeys(per_step, 0)
        check(counts == want and math.isfinite(hist[0]["loss"]),
              f"{name}: launches {counts}, want {want}; loss {hist[0]['loss']}")
        rules[name] = {"loss": hist[0]["loss"], "launches": counts,
                       "slots": sorted(state.slots)}
        del state
        torch.cuda.empty_cache()
    emit("C4_rules", rules)

    # the preconditioning time per step: update_apply of each optimizer on
    # the same params and gradients (AdamW leaves, gathers and scatters
    # included), 10 timed calls after 2 of warm-up, back to back (what a
    # step pays, the host's enqueueing included) and with the card held
    # busy while each call is enqueued (the card's time alone)
    cfg = get_config("gpt2-small")
    params = init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = map_with_path(lambda _p, t: (torch.randn(t.shape, generator=gen, device="cuda")
                                         * 1e-3).to(t.dtype), params)
    precond, spread = {}, {}
    for name in ("rmnp", "muon"):
        opt = make_optimizer(name, dict(lr_matrix=cosine_with_warmup(2e-3, 10),
                                        lr_adamw=cosine_with_warmup(1e-3, 10),
                                        fused=True, fused_apply=True))
        state = opt.init(params)
        run = (lambda o=opt, st=state: o.update_apply(grads, st, params, 5))
        calls, device = per_call_ms(run), per_call_ms(run, hold_cycles=200_000_000)
        precond[name] = statistics.median(calls)
        spread[name] = {kind: {"median": statistics.median(x), "min": min(x), "max": max(x),
                               "calls": x} for kind, x in (("calls", calls), ("device", device))}
        del state
    for kind in ("calls", "device"):
        r, m = spread["rmnp"][kind], spread["muon"][kind]
        print(f"preconditioning per step ({kind}; update_apply, gpt2-small, median (min-max) "
              f"of 10): rmnp {r['median']:.3f} ms ({r['min']:.3f}-{r['max']:.3f}), muon "
              f"{m['median']:.3f} ms ({m['min']:.3f}-{m['max']:.3f}), muon/rmnp "
              f"{m['median'] / r['median']:.2f}", flush=True)
    emit("C4_precondition_ms", {**precond, "muon_over_rmnp": precond["muon"] / precond["rmnp"],
                                "device_muon_over_rmnp": spread["muon"]["device"]["median"]
                                / spread["rmnp"]["device"]["median"], "spread": spread})
    del params, grads
    torch.cuda.empty_cache()
    return main_launches


@contextlib.contextmanager
def plain_calls():
    """Count calls of the kernels' plain versions (the CPU path) while the
    block runs; on the card none may run."""
    from repro_torch.kernels import ops, rmnp_update
    calls = {"n": 0}
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (rmnp_update, "rmnp_rownorm_plain"), (rmnp_update, "rmnp_rownorm_apply_plain"),
        (ops, "matmul_ref"), (ops, "ns_step_ref"))]
    for mod, name, fn in saved:
        def counted(*a, _fn=fn, **k):
            calls["n"] += 1
            return _fn(*a, **k)
        setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def max_abs_diff(a, b):
    """Largest |a - b| over two host copies of the same tree (as fp32)."""
    return max(float((x.float() - y.float()).abs().max()) for (_, x), (_, y) in zip(a, b, strict=True))


def phase_zero():
    """Z: ZeRO-2 at full width through a NCCL group of one rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import bucketing, cosine_with_warmup, make_optimizer
    from repro_torch.core.muon import newton_schulz
    from repro_torch.data.pipeline import make_stream
    from repro_torch.distributed import compression
    from repro_torch.distributed.comm import Comm, init_comm
    from repro_torch.kernels import LAUNCHES, ops, reset_launches
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.models import init_params
    from repro_torch.train import pipeline
    from repro_torch.train.dp_step import init_dp_state, make_dp_train_step

    comm = init_comm("cuda")
    check(dist.get_backend() == "nccl" and comm.world == 1, f"group {comm}, {dist.get_backend()}")
    cfg = get_config("gpt2-small")
    z_launches = {}

    # Z1: five runs of 3 steps of train(zero2=True), each from seed 0
    runs = {}
    for name, kw in (("exact_serial", dict(compress=False, overlap=False)),
                     ("exact_overlap", dict(compress=False, overlap=True)),
                     ("int8_serial", dict(compress=True, overlap=False)),
                     ("int8_overlap", dict(compress=True, overlap=True)),
                     ("exact_accum2", dict(compress=False, accum=2))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with plain_calls() as plain:
            params, state, hist = train("gpt2-small", reduced=False, optimizer="rmnp",
                                        fused=True, fused_apply=True, use_kernel=True,
                                        zero2=True, batch=8, seq=1024, steps=3,
                                        log_every=1, **kw)
        torch.cuda.synchronize()
        counts = dict(LAUNCHES)
        losses = [h["loss"] for h in hist]
        check(len(losses) == 3 and all(math.isfinite(x) for x in losses),
              f"Z1 {name}: losses {losses}")
        check([h["launches"]["rmnp_apply"] for h in hist] == [4, 4, 4],
              f"Z1 {name}: apply launches per step {[h['launches'] for h in hist]}")
        check(plain["n"] == 0, f"Z1 {name}: {plain['n']} plain-version calls")
        runs[name] = {"final": host_copy((params, state.buckets)), "losses": losses,
                      "step_s": step_seconds(hist), "launches": counts,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                      "plain_calls": plain["n"]}
        z_launches.setdefault("rmnp_apply", counts["rmnp_apply"])
        del params, state
    # the world-1 ZeRO-0 dp step from the same init, schedules and batches
    torch.cuda.empty_cache()
    opt = make_optimizer("rmnp", dict(
        lr_matrix=cosine_with_warmup(2e-3, 3), lr_adamw=cosine_with_warmup(1e-3, 3),
        fused=True, fused_apply=True, shard_axis=comm, shard_size=1))
    params = init_params(cfg, seed=0, device=comm.device)
    st, comp = init_dp_state(opt, params, comm)
    fn = make_dp_train_step(cfg, opt, comm, compress=False, remat="full")
    stream = make_stream(cfg, 1024, 8, seed=0)
    for t in range(3):
        params, st, comp, _ = fn(params, st, comp, batch_to_device(next(stream), comm.device), t)
    zero0 = host_copy((params, st.buckets))
    del params, st, comp
    # step times at a finer grain than train()'s 10 ms log: the single-device
    # step of C1 and each ZeRO-2 form on one batch, 5 rounds taken in turns,
    # each step ended by a synchronize; medians
    from repro_torch.train.step import make_train_step
    params = init_params(cfg, seed=0, device=comm.device)
    batch = batch_to_device(make_stream(cfg, 1024, 8, seed=0).sample(0), comm.device)
    forms = {}
    for name, kw in (("exact_serial", dict(compress=False, overlap=False)),
                     ("exact_overlap", dict(compress=False, overlap=True)),
                     ("int8_serial", dict(compress=True, overlap=False)),
                     ("int8_overlap", dict(compress=True, overlap=True)),
                     ("exact_accum2", dict(compress=False, accum=2))):
        opt_z = make_optimizer("rmnp", dict(lr_matrix=2e-3, lr_adamw=1e-3, fused_apply=True,
                                            shard_axis=comm, shard_size=1))
        st_z, comp_z = init_dp_state(opt_z, params, comm, shard_state=True)
        forms[name] = [make_dp_train_step(cfg, opt_z, comm, zero2=True, remat="full", **kw),
                       [params, st_z, comp_z]]
    opt_c1 = make_optimizer("rmnp", dict(lr_matrix=2e-3, lr_adamw=1e-3, fused_apply=True))
    c1_step = make_train_step(cfg, opt_c1, remat="full")
    forms["single_device_C1"] = [lambda p, o, c, b, t: c1_step(p, o, b, t) + (None,),
                                 [params, opt_c1.init(params), None]]
    samples = {name: [] for name in forms}
    for rnd in range(6):  # round 0 warms up
        for name, (fn_z, st_list) in forms.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn_z(*st_list, batch, rnd + 1)
            torch.cuda.synchronize()
            if rnd:
                samples[name].append(round((time.perf_counter() - t0) * 1e3, 3))
            st_list[:] = out[:3] if name != "single_device_C1" else [out[0], out[1], None]
    step_ms = {name: statistics.median(v) for name, v in samples.items()}
    del forms, params, batch, opt_c1, c1_step
    torch.cuda.empty_cache()
    bad = {"exact_serial vs zero0": differing(runs["exact_serial"]["final"], zero0),
           "exact_overlap vs exact_serial": differing(runs["exact_overlap"]["final"],
                                                      runs["exact_serial"]["final"]),
           "int8_overlap vs int8_serial": differing(runs["int8_overlap"]["final"],
                                                    runs["int8_serial"]["final"])}
    c1 = C1_FINAL["final"]
    emit("Z1_zero2", {
        "runs": {k: {kk: vv for kk, vv in v.items() if kk != "final"} for k, v in runs.items()},
        "bitwise_failures": bad, "step_ms_median": step_ms, "step_ms_samples": samples,
        "c1_step_s": C1_FINAL["step_s"], "c1_peak_mem_gb": C1_FINAL["peak_mem_gb"],
        "exact_vs_c1_max_abs": max_abs_diff(runs["exact_serial"]["final"], c1),
        "exact_vs_c1_bitwise": not differing(runs["exact_serial"]["final"], c1),
        "accum2_vs_exact_max_abs": max_abs_diff(runs["exact_accum2"]["final"],
                                                runs["exact_serial"]["final"]),
        "int8_vs_exact_max_abs": max_abs_diff(runs["int8_serial"]["final"],
                                              runs["exact_serial"]["final"])})
    for what, paths in bad.items():
        check(not paths, f"Z1 {what}: differs at {paths[:4]}")
    del runs

    # Z2: each rank's slice of a padded bucket through the kernel equals that
    # slice of the whole stack's result, at shard sizes 4 and 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    shards = []
    for model, buckets in (("gpt2-small", BUCKETS), ("llama-130m", LLAMA_BUCKETS)):
        for n in (4, 8):
            for (L, d_in, d_out) in buckets:
                padded = -(-L // n) * n
                rows = padded // n
                g = torch.randn((padded, d_in, d_out), generator=gen, device="cuda")
                v = torch.randn((padded, d_in, d_out), generator=gen, device="cuda")
                w = torch.randn((padded, d_in, d_out), generator=gen, device="cuda").bfloat16()
                for t in (g, v, w):
                    t[L:] = 0
                scale = torch.tensor(2e-3)
                v_all, w_all = ops.rmnp_bucket_update_apply(g, v, w, scale, 0.1, beta=0.95)
                same = True
                for r in range(n):
                    part = slice(r * rows, (r + 1) * rows)
                    v_r, w_r = ops.rmnp_bucket_update_apply(
                        g[part].clone(), v[part].clone(), w[part].clone(), scale, 0.1, beta=0.95)
                    same = same and torch.equal(v_r, v_all[part]) and torch.equal(
                        w_r.view(torch.int16), w_all[part].view(torch.int16))
                pads_zero = not (v_all[L:].any() or w_all[L:].any())
                shards.append({"model": model, "n": n, "bucket": [padded, d_in, d_out],
                               "slices_bitwise": bool(same), "pads_zero": bool(pads_zero)})
                del g, v, w, v_all, w_all
    x = torch.randn((48, 768, 768), generator=gen, device="cuda")
    ns_all = newton_schulz(x)
    ns_same = {n: all(torch.equal(newton_schulz(x[r * 48 // n:(r + 1) * 48 // n].clone()),
                                  ns_all[r * 48 // n:(r + 1) * 48 // n]) for r in range(n))
               for n in (4, 8)}
    del x, ns_all
    torch.cuda.empty_cache()
    emit("Z2_shard_slices", {"rmnp_apply": shards, "newton_schulz_768x768": ns_same})
    check(all(s["slices_bitwise"] and s["pads_zero"] for s in shards),
          f"Z2: {[s for s in shards if not (s['slices_bitwise'] and s['pads_zero'])]}")
    check(all(ns_same.values()), f"Z2 Newton-Schulz slices: {ns_same}")

    # Z3: the int8 quantizer and one world-1 reduce-scatter on the card
    # against the CPU, on the 768x768 bucket's gradient; Muon ZeRO-2 against
    # its ZeRO-0 step
    params = init_params(cfg, seed=0, device=comm.device)
    batch = batch_to_device(make_stream(cfg, 1024, 8, seed=0).sample(0), comm.device)
    rmnp_opt = make_optimizer("rmnp", dict(lr_matrix=2e-3, fused_apply=True))
    grads, _ = pipeline.grads_of(cfg, params, batch, "full")
    plan = rmnp_opt.bucket_plan(params)
    with torch.no_grad():
        chunks = bucketing.gather_chunks(plan, grads, 1, dtype=torch.float32)["768x768"]
    del grads
    q, s = compression.quantize_blockwise(chunks.reshape(-1))
    q_cpu, s_cpu = compression.quantize_blockwise(chunks.reshape(-1).cpu())
    quant_same = torch.equal(q.cpu(), q_cpu) and torch.equal(
        s.cpu().view(torch.int32), s_cpu.view(torch.int32))
    cpu_comm = Comm(dist.new_group(backend="gloo"), 0, 1, torch.device("cpu"))
    mean, resid = compression.compressed_reduce_scatter_leaf(chunks, comm)
    mean_cpu, resid_cpu = compression.compressed_reduce_scatter_leaf(chunks.cpu(), cpu_comm)
    rs_same = torch.equal(mean.cpu(), mean_cpu) and torch.equal(resid.cpu(), resid_cpu)
    del chunks, mean, resid, mean_cpu, resid_cpu, q, s
    muon = make_optimizer("muon", dict(lr_matrix=2e-3, lr_adamw=1e-3, fused_apply=True,
                                       shard_axis=comm, shard_size=1))
    finals = {}
    for mode in ("zero2", "zero0"):
        st, comp = init_dp_state(muon, params, comm, shard_state=mode == "zero2")
        fn = make_dp_train_step(cfg, muon, comm, compress=False, remat="full",
                                zero2=mode == "zero2")
        reset_launches()
        p, st, comp, m = fn(params, st, comp, batch, 1)
        torch.cuda.synchronize()
        if mode == "zero2":
            muon_launches = {k: LAUNCHES[k] for k in ("matmul3", "ns_poly3", "matmul", "ns_poly")}
        finals[mode] = host_copy((p, st.buckets))
        del p, st, comp
    muon_bad = differing(finals["zero2"], finals["zero0"])
    emit("Z3_int8_and_muon", {"quantize_card_equals_cpu": quant_same,
                              "reduce_scatter_card_equals_cpu": rs_same,
                              "muon_zero2_vs_zero0_differing": muon_bad,
                              "muon_zero2_launches_per_step": muon_launches})
    check(quant_same, "Z3: int8 codes or scales differ between the card and the CPU")
    check(rs_same, "Z3: the world-1 reduce-scatter differs between the card and the CPU")
    check(not muon_bad, f"Z3: Muon ZeRO-2 differs from ZeRO-0 at {muon_bad[:4]}")
    check(muon_launches["matmul3"] == 40 and muon_launches["ns_poly3"] == 20,
          f"Z3 Muon launches {muon_launches}")
    z_launches.update({k: muon_launches[k] for k in ("matmul3", "ns_poly3")})
    del params, batch, finals
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return z_launches


def phase_small():
    """Reduced gpt2 (fp32) with attn_impl="pallas", under RMNP and under Muon:
    the RMNP apply kernel, the GEMM kernel that carries Newton-Schulz and the
    flash-attention kernel on the card against their plain versions on the
    CPU. fp32 matmuls on the card run without TF32, and the losses and
    parameters agree to 1e-4 relative after 3 steps (Newton-Schulz keeps a
    relative difference near its size, see NS_REL_TOL). Then reduced qwen3
    serving, and reduced deepseek-v2-lite-16b and minicpm3-4b (MLA, MoE),
    xlstm-350m (mLSTM, sLSTM) and jamba-v0.1-52b (mamba, GQA, MoE) loss,
    gradients and serving, card against CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.core.types import tree_map, tree_paths
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import init_params
    from repro_torch.train.step import make_train_step

    cfg = dataclasses.replace(get_config("gpt2-small").reduced(), attn_impl="pallas")
    init = init_params(cfg, seed=0, device="cpu")  # one init, copied to the card
    for name in ("rmnp", "muon"):
        runs = {}
        for device in ("cuda", "cpu"):
            opt = make_optimizer(name, dict(
                lr_matrix=cosine_with_warmup(2e-3, 3), lr_adamw=cosine_with_warmup(1e-3, 3),
                fused=True, fused_apply=True, use_kernel=True))
            params = tree_map(lambda t, d=device: t.to(d), init)
            state = opt.init(params)
            step_fn = make_train_step(cfg, opt, remat="none")
            stream = make_stream(cfg, 64, 4, seed=0)
            reset_launches()
            losses = []
            for step in range(3):
                params, state, metrics = step_fn(params, state,
                                                 batch_to_device(next(stream), device), step)
                losses.append(float(metrics["loss"]))
            on_card = device == "cuda"
            n_buckets = len(opt.bucket_plan(params).buckets)
            want = {"flash_attention_fwd": 3 * cfg.num_layers * on_card,
                    "rmnp_apply": 3 * n_buckets * on_card * (name == "rmnp"),
                    "matmul3": 3 * 10 * n_buckets * on_card * (name == "muon"),
                    "ns_poly3": 3 * 5 * n_buckets * on_card * (name == "muon")}
            check(all(LAUNCHES[k] == n for k, n in want.items()),
                  f"{name} {device} launches {dict(LAUNCHES)}, want {want}")
            runs[device] = (losses, {p: t.float().cpu() for p, t in tree_paths(params)})
        loss_err = max(abs(a - b) for a, b in zip(runs["cuda"][0], runs["cpu"][0], strict=True))
        p_err = max(max_err(runs["cuda"][1][p], runs["cpu"][1][p]) for p in runs["cpu"][1])
        check(loss_err <= 1e-4 * abs(runs["cpu"][0][0]),
              f"{name} small losses cuda {runs['cuda'][0]} cpu {runs['cpu'][0]}")
        check(p_err <= 1e-4, f"{name} small params max_abs_err {p_err}")
        emit("D_small_vs_cpu" if name == "rmnp" else f"D_{name}_small_vs_cpu",
             {"losses_cuda": runs["cuda"][0], "losses_cpu": runs["cpu"][0],
              "loss_abs_err": loss_err, "param_max_abs_err": p_err})

    # reduced qwen3 serving in fp32 (GQA, hd 16, the fp32 flash kernel in
    # the prefill): prefill and 8 decode steps on the card against the CPU
    # from one CPU init. fp32 matmuls run without TF32, so the greedy tokens
    # are equal and every logit agrees to 1e-4 of the largest.
    from repro_torch.launch.serve import generate
    cfg = get_config("qwen3-4b").reduced(**D_QWEN3)
    init = init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab, (4, 64), generator=torch.Generator().manual_seed(1))
    served = {}
    for device in ("cuda", "cpu"):
        reset_launches()
        served[device] = generate(cfg, tree_map(lambda t, d=device: t.to(d), init),
                                  prompts.to(device), 9, keep_logits=True)
        want = cfg.num_layers * (device == "cuda")
        check(LAUNCHES["flash_attention_fwd"] == want,
              f"qwen3 serving {device}: flash launches {dict(LAUNCHES)}, want {want}")
    same = torch.equal(served["cuda"]["tokens"].cpu(), served["cpu"]["tokens"])
    rel = max(max_err(a.cpu(), b) / float(b.abs().max())
              for a, b in zip(served["cuda"]["logits"], served["cpu"]["logits"], strict=True))
    emit("D_qwen3_serve_vs_cpu", {"tokens_equal": same, "logits_rel_err": rel,
                                  "tokens_cuda": served["cuda"]["tokens"].tolist()})
    check(same, "reduced qwen3 serving: greedy tokens differ between the card and the CPU")
    check(rel <= 1e-4, f"reduced qwen3 serving: logits {rel} of the largest apart")

    # reduced deepseek-v2-lite-16b (MLA, a dense prefix layer, MoE units
    # with a shared expert) and minicpm3-4b (MLA with the q-LoRA branch) in
    # fp32 with attn_impl="pallas" (the fp32 kernel at the reduced MLA's head
    # dim 16): one loss and every gradient, and served tokens, card against
    # CPU from one CPU init; the same 1e-4 bounds, and the MoE routing must
    # match (fp32 router probabilities, no near tie at these draws)
    from repro_torch.models import moe
    from repro_torch.models.model import loss_fn
    # reduced xlstm-350m (mLSTM and sLSTM) and jamba-v0.1-52b (mamba, GQA
    # with the fp32 kernel at hd 16, MoE) under the same checks; then each
    # fp32 wide build through a whole reduced model at its full
    # config's head dims (full_head_dims): qwen3-4b at hd 128 (G = 4),
    # phi3-mini-3.8b at 96, minicpm3-4b's MLA at 64 + 32 / 64, deepseek's
    # at 128 + 64 / 128, paligemma-3b at 256 (the prompt's image embeddings
    # from launch/serve.prompt_batch)
    from repro_torch.launch.serve import prompt_batch
    configs = [(arch, get_config(arch).reduced(attn_impl="pallas")) for arch in (
        "deepseek-v2-lite-16b", "minicpm3-4b", "xlstm-350m", "jamba-v0.1-52b")]
    for arch in (*D_GQA_HEADS, *D_MLA_HEADS):
        cfg = full_head_dims(arch)
        m = cfg.mla
        hd, hdv = (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) if m else (
            cfg.head_dim, cfg.head_dim)
        configs.append((f"{arch}_hd{hd}_{hdv}", cfg))
    d_launches = {}  # flash launches of each config's loss on the card
    for arch, cfg in configs:
        n_attn = sum(m in ("gqa", "mla") for m, _ in cfg.pattern)
        init = init_params(cfg, seed=0, device="cpu")
        batch = make_stream(cfg, 64, 4, seed=0).sample(0)
        if cfg.frontend == "none":
            prompts = torch.randint(0, cfg.vocab, (4, 32),
                                    generator=torch.Generator().manual_seed(1))
        else:
            prompts = prompt_batch(cfg, 4, 32, seed=1, device="cpu")
        runs = {}
        for device in ("cuda", "cpu"):
            params = tree_map(lambda t, d=device: t.to(d).requires_grad_(True), init)
            routes = []
            with routing(moe, record=routes):
                reset_launches()
                loss, metrics = loss_fn(cfg, params, batch_to_device(batch, device),
                                        remat="none")
                grads = torch.autograd.grad(loss, [t for _, t in tree_paths(params)])
            routes = [r.cpu() for r in routes]
            launches = LAUNCHES["flash_attention_fwd"]
            with torch.no_grad():
                served = generate(cfg, tree_map(lambda t: t.detach(), params),
                                  tree_map(lambda t, d=device: t.to(d), prompts), 9,
                                  keep_logits=True)
            runs[device] = (float(loss.detach()), float(metrics["aux"].detach()),
                            [g.float().cpu() for g in grads], served, routes, launches)
        d_launches[arch] = runs["cuda"][5]
        (lc, ac, gc, sc, rc, nc), (lp, ap, gp, sp, rp, _) = runs["cuda"], runs["cpu"]
        g_err = max(max_err(a, b) / max(float(b.abs().max()), 1e-30)
                    for a, b in zip(gc, gp, strict=True))
        same = torch.equal(sc["tokens"].cpu(), sp["tokens"])
        rel = max(max_err(a.cpu(), b) / float(b.abs().max())
                  for a, b in zip(sc["logits"], sp["logits"], strict=True))
        routes_equal = len(rc) == len(rp) and all(torch.equal(a, b) for a, b in zip(rc, rp))
        emit(f"D_{arch}_vs_cpu", {"loss_cuda": lc, "loss_cpu": lp, "aux_cuda": ac,
                                  "aux_cpu": ap, "grad_rel_err": g_err,
                                  "tokens_equal": same, "logits_rel_err": rel,
                                  "routing_equal": routes_equal, "moe_layers": len(rc),
                                  "flash_launches_loss": nc})
        check(nc == n_attn, f"{arch}: flash launches {nc}, want {n_attn}")
        check(abs(lc - lp) <= 1e-4 * abs(lp) and abs(ac - ap) <= 1e-4 * max(abs(ap), 1e-30),
              f"{arch}: loss cuda {lc} cpu {lp}, aux {ac} {ap}")
        check(g_err <= 1e-4, f"{arch}: gradients {g_err} of the largest apart")
        check(routes_equal, f"{arch}: MoE routing differs between the card and the CPU")
        check(same and rel <= 1e-4, f"{arch} serving: tokens equal {same}, logits {rel}")
    return d_launches


def phase_serve(arch, tag):
    """S: serving qwen3-4b at full width (bf16, seed 0, B=8, T=1024, 128
    new tokens, S_max=1152) through launch/serve.serve and the step
    functions. S1 the flash prefill against the dense one, and a non-causal
    control; S2 the decode steps' logits against a teacher-forced dense
    forward over the prompt and the first 16 generated tokens, and a
    control decoding at pos + 1; S3 the timings and peak memory. H and N
    run the same for phi3-mini-3.8b and minicpm3-4b (``arch``; ``tag`` names
    the phase in its record and its messages)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_paths
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import place_cache, serve
    from repro_torch.models import init_params, layers
    from repro_torch.models.model import forward, init_cache, lm_head
    from repro_torch.train.step import make_prefill_step, make_serve_step

    phase_t0 = time.perf_counter()
    base = get_config(arch)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(base, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = torch.randint(0, base.vocab, (S_BATCH, S_PROMPT), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
    n_params = sum(t.numel() for _, t in tree_paths(params))
    real = slice(0, base.vocab)

    def rel(a, b):
        a, b = a[..., real].float(), b[..., real].float()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    # S3 first, on a cold allocator: a short warm-up, then the timed run,
    # which keeps no logits, so its peak memory is serving's own; then the
    # checked run keeps every step's logits for S1 and S2 and must generate
    # the timed run's tokens
    serve(arch, full=True, batch=S_BATCH, prompt_len=S_PROMPT, tokens=4,
          attn_impl="pallas", params=params, prompts=prompts)
    runs = {}
    for run, keep in (("timed", False), ("checked", True)):
        torch.cuda.empty_cache()
        reset_launches()
        runs[run] = serve(arch, full=True, batch=S_BATCH, prompt_len=S_PROMPT,
                          tokens=S_TOKENS, attn_impl="pallas", params=params, prompts=prompts,
                          keep_logits=keep)
        serve_launches = LAUNCHES["flash_attention_fwd"]
        check(serve_launches == base.num_layers,
              f"{tag} ({run}): {serve_launches} flash launches in a served batch, "
              f"want {base.num_layers}")
    checked, res = runs["checked"], runs["timed"]
    del runs
    seqs = checked["tokens"]
    check(seqs.shape == (S_BATCH, S_TOKENS) and int(seqs.min()) >= 0
          and int(seqs.max()) < base.vocab, f"{tag}: generated tokens {seqs.shape}")
    check(torch.equal(seqs, res["tokens"]),
          f"{tag}: the checked run's tokens differ from the timed run's")
    check(all(torch.isfinite(x.float()).all().item() for x in checked["logits"]),
          f"{tag}: non-finite logits")

    # S1: the prefill in each mode from the same parameters, each timed
    # (CUDA events around 5 calls after one warm-up), and a non-causal
    # control; the flash prefill must launch the kernel once a layer
    dense_attention = layers.attention
    last, prefill_ms, launches = {}, {}, {}
    batch = {"tokens": prompts}
    for run in ("pallas", "dense", "control"):
        cfg = dataclasses.replace(base, attn_impl="dense" if run == "control" else run)
        step = make_prefill_step(cfg)
        if run == "control":
            layers.attention = lambda q, k, v, causal=True, **kw: dense_attention(
                q, k, v, False, **kw)
        try:
            reset_launches()
            last[run] = step(params, batch)[0]
            launches[run] = LAUNCHES["flash_attention_fwd"]
            if run != "control":
                prefill_ms[run] = per_call_ms(lambda st=step: st(params, batch), iters=5,
                                              warmup=1)
        finally:
            layers.attention = dense_attention
        torch.cuda.empty_cache()
    check(launches == {"pallas": base.num_layers, "dense": 0, "control": 0},
          f"{tag}1: flash launches per prefill {launches}")
    s1 = rel(last["pallas"], last["dense"])
    s1_control = rel(last["control"], last["dense"])
    agree = float((last["pallas"][:, real].argmax(-1) == last["dense"][:, real].argmax(-1))
                  .float().mean())
    check(torch.equal(last["pallas"], checked["logits"][0]),
          f"{tag}1: the served prefill's logits differ from the prefill step's")

    # S2: teacher-force the prompt and the first S_FORCED generated tokens
    # through a dense forward; its logits at positions T .. T+F-1 against
    # the decode steps that consumed those tokens at those positions
    dense_cfg = dataclasses.replace(base, attn_impl="dense")
    forced = torch.cat([prompts, seqs[:, :S_FORCED].long()], dim=1)
    with torch.no_grad():
        hidden = forward(dense_cfg, params, {"tokens": forced}, "train",
                         return_hidden=True)[0]
        want = hidden[:, S_PROMPT:S_PROMPT + S_FORCED] @ lm_head(base, params)
    del hidden
    got = torch.stack(checked["logits"][1:S_FORCED + 1], dim=1)
    s2 = rel(got, want)
    # the control: the same tokens decoded one position late, from the same
    # prompt cache
    _, pc = make_prefill_step(dense_cfg)(params, batch)
    cache = place_cache(init_cache(dense_cfg, S_BATCH, S_PROMPT + S_TOKENS + 1,
                                   device="cuda"), pc)
    del pc
    serve_step = make_serve_step(dense_cfg)
    shifted = []
    for i in range(S_FORCED):
        _, lg, cache = serve_step(params, cache, seqs[:, i:i + 1], S_PROMPT + i + 1)
        shifted.append(lg[:, 0])
    s2_control = rel(torch.stack(shifted, dim=1), want)
    del cache, shifted, want, got, checked
    torch.cuda.empty_cache()

    decode = res["decode_ms"]

    def summary(xs):
        return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}

    card = card_name()
    record = {
        "card": card, "config": arch, "params": n_params, "batch": S_BATCH,
        "prompt_len": S_PROMPT, "new_tokens": S_TOKENS, "init_s": init_s,
        "S1_logits_rel_flash_vs_dense": s1, "S1_logits_rel_control": s1_control,
        "S1_greedy_agreement": agree, "S2_logits_rel_decode_vs_forced": s2,
        "S2_logits_rel_control": s2_control, "tolerance": S_LOGIT_TOL,
        "flash_launches_per_prefill": launches["pallas"],
        "prefill_ms": {run: summary(ms) for run, ms in prefill_ms.items()},
        "prefill_samples_ms": prefill_ms,
        "served_prefill_ms": res["prefill_ms"], "place_ms": res["place_ms"],
        "decode_ms_per_step": summary(decode), "decode_steps": len(decode),
        "decode_samples_ms": decode, "decode_tokens_per_s": res["decode_tokens_per_s"],
        "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
        "peak_mem_gb": res["peak_bytes"] / 2**30, "held_at_reset_gb": res["held_bytes"] / 2**30,
        "tokens_head": seqs[:, :8].tolist(), "phase_s": time.perf_counter() - phase_t0}
    emit(f"{tag}_serve_" + arch.replace("-", "_").replace(".", "_"), record)
    for run, ms in prefill_ms.items():
        m = summary(ms)
        print(f"{tag}3 ({card}): prefill {run} {m['median']:.2f} ms ({m['min']:.2f}-"
              f"{m['max']:.2f})", flush=True)
    d = summary(decode)
    print(f"{tag}3 ({card}): decode {d['median']:.3f} ms a step ({d['min']:.3f}-{d['max']:.3f}, "
          f"{len(decode)} steps)", flush=True)
    print(f"{tag}3 ({card}): {res['decode_tokens_per_s']:.1f} decode tokens/s, "
          f"{res['tokens_per_s']:.1f} tokens/s end to end", flush=True)
    print(f"{tag}3 ({card}): peak device memory {record['peak_mem_gb']:.2f} GiB", flush=True)
    print(f"{tag}1/{tag}2: flash vs dense {s1:.3e} (control {s1_control:.3e}); decode vs forced "
          f"{s2:.3e} (control {s2_control:.3e}); tolerance {S_LOGIT_TOL}", flush=True)
    check(s1 <= S_LOGIT_TOL, f"{tag}1: flash prefill logits {s1} from dense > {S_LOGIT_TOL}")
    check(s1_control > S_LOGIT_TOL,
          f"{tag}1: the non-causal control is only {s1_control} from dense, inside "
          f"the tolerance {S_LOGIT_TOL}")
    check(s2 <= S_LOGIT_TOL, f"{tag}2: decode logits {s2} from the forced forward > {S_LOGIT_TOL}")
    check(s2_control > S_LOGIT_TOL,
          f"{tag}2: decoding at pos + 1 is only {s2_control} from the forced forward, inside "
          f"the tolerance {S_LOGIT_TOL}")
    del params, res, last
    torch.cuda.empty_cache()
    return serve_launches


R_ARCH, R_BATCH, R_SEQ, R_STEPS = "llama-130m", 8, 1024, 6
# Phase S, serving qwen3-4b at full width in bf16: B requests of a T-token
# prompt, N new tokens, S_max = T + N; S2 teacher-forces the first F.
S_ARCH, S_BATCH, S_PROMPT, S_TOKENS, S_FORCED = "qwen3-4b", 8, 1024, 128, 16
# Phases H and N serve phi3-mini-3.8b (hd 96, H = K = 32, 32 layers) and
# minicpm3-4b (MLA's q/k 96 and v 64, H = K = 40, 62 layers) the same way,
# through the bf16 kernel's (96, 96) and (96, 64) builds
H_ARCH, N_ARCH = "phi3-mini-3.8b", "minicpm3-4b"
# S1 and S2 compare logits (the real vocabulary) by their relative Frobenius
# distance. The flash prefill keeps P to fp32 accuracy where dense attention
# rounds its probabilities to bf16, and a decode step runs dense attention's
# arithmetic over the cache while the teacher-forced forward batches the
# same products into other shapes: each pair differs by bf16 rounding (2^-8
# of a value) carried through 36 layers. The tolerance sits a few times
# above the readings on an H100 (PERF.md); each control (a non-causal
# prefill; decoding at pos + 1) must land outside it. H and N hold the same
# tolerance over 32 and 62 layers.
S_LOGIT_TOL = 5e-2
# Phase D's reduced qwen3 keeps GQA (plain .reduced() gives H = K = 4)
D_QWEN3 = dict(n_heads=8, n_kv_heads=2, head_dim=16, attn_impl="pallas")
# Phase D at the full configs' head dims: GQA archs (with the reduced heads'
# overrides) and MLA archs
D_GQA_HEADS = {"qwen3-4b": dict(n_heads=8, n_kv_heads=2), "phi3-mini-3.8b": {},
               "paligemma-3b": {}}
D_MLA_HEADS = ("minicpm3-4b", "deepseek-v2-lite-16b")


def full_head_dims(arch):
    """``arch`` reduced (width, depth, vocab) with attn_impl="pallas" and its
    full config's head dims: hd for GQA, MLA's nope, rope and v head dims."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    cfg = full.reduced(attn_impl="pallas", **D_GQA_HEADS.get(arch, {}))
    if full.mla is None:
        return dataclasses.replace(cfg, head_dim=full.head_dim)
    return dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, qk_nope_head_dim=full.mla.qk_nope_head_dim,
        qk_rope_head_dim=full.mla.qk_rope_head_dim, v_head_dim=full.mla.v_head_dim))


M_ARCH = "deepseek-v2-lite-16b"
# Phase M1: the 3-layer cut (the dense prefix and 2 MoE units) at full width
M1_LAYERS, M1_BATCH, M1_SEQ, M1_STEPS = 3, 8, 1024, 3
# Phase M2: the whole model served in bf16, as phase S serves qwen3-4b
M_BATCH, M_PROMPT, M_TOKENS, M_FORCED = 8, 1024, 128, 16
# M2 compares logits (the real vocabulary) by their relative Frobenius
# distance, as S1/S2 do: flash against dense prefill, and decode against a
# teacher-forced dense forward, at capacity factor E / K (nothing dropped)
# and with the reference run's expert choices replayed into the other, so
# that each pair differs by bf16 rounding carried through 27 layers, as
# qwen3-4b's 36 do (2.0e-2 and 1.9e-2 there, PERF.md). The tolerance is S's,
# and each control (a non-causal prefill; decoding at pos + 1) must land at
# least 4x outside it. With free routing a tie in the top-6 flips either way
# and a flipped expert moves its token by about 1/K of the routed output;
# those distances and the share of routings that agree are reported only.
M_LOGIT_TOL = 5e-2
M_CONTROL_FACTOR = 4.0
# Phase Y serves yi-9b whole as S serves qwen3-4b (48 layers, H = 32 on K =
# 4 at hd 128: the bf16 hd-128 build at a GQA group of 8) and Y2 trains it
# cut in depth as M1 trains deepseek; phase O serves olmoe-1b-7b whole as M2
# serves deepseek (16 layers, H = K = 16 at hd 128 with qk_norm, 64 experts
# top-8) and O2 trains it cut. Both cuts keep layers CUT_LAYERS.
Y_ARCH, O_ARCH, CUT_LAYERS = "yi-9b", "olmoe-1b-7b", "0:2"


def m1_config():
    """deepseek-v2-lite-16b cut to its first M1_LAYERS layers, full width."""
    from repro_torch.configs import get_config
    base = get_config(M_ARCH)
    return dataclasses.replace(base, num_layers=M1_LAYERS, pattern=base.pattern[:M1_LAYERS])


def cut_config(arch):
    """``arch`` cut to layers CUT_LAYERS at full width (configs.cut_layers,
    what ``--layers`` does)."""
    from repro_torch.configs import cut_layers, get_config
    return cut_layers(get_config(arch), CUT_LAYERS)


def train_cut(tag, record_name, cfg, buckets, describe):
    """M1-style training of ``cfg``, a model cut in depth at full width,
    with single-pass RMNP (B=8, S=1024, bf16, seed 0): M1_STEPS timed steps
    with one apply launch a bucket each, tokens/s and peak memory; a second
    run from the same seed equals the first bit for bit after 2 steps; where
    the model has expert stacks (4-D leaves), the per-leaf engine equals the
    single-pass one bit for bit on them. An MoE model's aux losses must be
    positive. ``tag`` names the phase in its messages, ``record_name`` its
    record."""
    import torch
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.core.types import tree_paths
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device
    from repro_torch.models import init_params
    from repro_torch.train.step import make_train_step

    n_buckets = len(buckets)

    def run(steps, timed):
        opt = make_optimizer("rmnp", dict(
            lr_matrix=cosine_with_warmup(2e-3, M1_STEPS),
            lr_adamw=cosine_with_warmup(1e-3, M1_STEPS), fused=True, fused_apply=True))
        params = init_params(cfg, seed=0, device="cuda")
        state = opt.init(params)
        step_fn = make_train_step(cfg, opt, remat="full")
        stream = make_stream(cfg, M1_SEQ, M1_BATCH, seed=0)
        out = {"losses": [], "aux": [], "step_s": [], "launches": [], "after_2": None}
        for step in range(steps):
            batch = batch_to_device(next(stream), "cuda")
            before = dict(LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch, step)
            out["losses"].append(float(metrics["loss"]))  # a host read ends the step
            out["step_s"].append(time.perf_counter() - t0)
            out["aux"].append(float(metrics["aux"]))
            out["launches"].append({k: LAUNCHES[k] - before[k] for k in LAUNCHES})
            if step == 1:
                out["after_2"] = host_copy((params, state.buckets))
        out["buckets"] = {k: list(b.shape) for k, b in state.buckets.items()}
        out["params"] = sum(t.numel() for _, t in tree_paths(params))
        del params, state
        torch.cuda.empty_cache()
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_launches()
    first = run(M1_STEPS, True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = LAUNCHES["rmnp_apply"]
    second = run(2, False)
    diff = differing(first["after_2"], second["after_2"])
    steady = first["step_s"][1:]
    tokens = M1_BATCH * M1_SEQ
    check(sorted(first["buckets"]) == sorted(f"{a}x{b}" for _, a, b in buckets),
          f"{tag} buckets {first['buckets']}")
    check(all(math.isfinite(x) for x in first["losses"]), f"{tag} losses {first['losses']}")
    if cfg.moe is not None:
        check(all(a > 0 for a in first["aux"]), f"{tag}: the aux losses {first['aux']}")
    check([s["rmnp_apply"] for s in first["launches"]] == [n_buckets] * M1_STEPS,
          f"{tag} apply launches per step {first['launches']}")

    # the per-leaf engine against the single-pass one on the expert stacks:
    # one step from the same weights and gradients, bit for bit, in fp32
    # (in bf16 the two-pass form rounds the update to bf16 before adding
    # it, the apply kernel rounds w + update once: they differ by design)
    params = init_params(cfg, seed=0, device="cuda")
    stacks = {p: t.float() for p, t in tree_paths(params) if t.ndim == 4}
    del params
    engines_diff = None
    if stacks:
        gen = torch.Generator(device="cuda").manual_seed(5)
        grads = {p: 1e-3 * torch.randn(t.shape, generator=gen, device="cuda")
                 for p, t in stacks.items()}
        outs = {}
        for engine, kw in (("per-leaf", dict(fused=False, fused_apply=False)),
                           ("single-pass", dict(fused=True, fused_apply=True))):
            opt = make_optimizer("rmnp", dict(lr_matrix=cosine_with_warmup(2e-3, 3), **kw))
            state = opt.init(stacks)
            if opt.update_apply is not None:
                new, state = opt.update_apply(grads, state, stacks, 1)
            else:
                from repro_torch.core import apply_updates
                updates, state = opt.update(grads, state, stacks, 1)
                new = apply_updates(stacks, updates)
            outs[engine] = host_copy(new)
            del new, state
        engines_diff = differing(outs["per-leaf"], outs["single-pass"])
        del grads, outs
    del stacks
    torch.cuda.empty_cache()
    card = card_name()
    record = {
        "card": card, "config": describe, "params": first["params"], "batch": M1_BATCH,
        "seq": M1_SEQ, "losses": first["losses"], "aux": first["aux"],
        "step_s": first["step_s"], "tokens_per_s": tokens / statistics.median(steady),
        "peak_mem_gb": peak, "held_at_reset_gb": held / 2**30,
        "launches_per_step": first["launches"],
        "buckets": first["buckets"], "bitwise_equal_after_2_steps": not diff,
        "differing": diff[:20], "losses_second_run": second["losses"]}
    if engines_diff is not None:
        record.update(per_leaf_equals_single_pass_on_expert_stacks=not engines_diff,
                      engines_differing=engines_diff)
    emit(record_name, record)
    print(f"{tag} ({card}): steps {[round(x, 4) for x in first['step_s']]} s, "
          f"{record['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GiB, "
          f"{n_buckets} apply launches a step, two runs equal: {not diff}", flush=True)
    check(not diff, f"{tag}: two runs from one seed differ after 2 steps in {diff[:5]}")
    check(not engines_diff, f"{tag}: per-leaf and single-pass differ on {engines_diff}")
    return {"rmnp_apply": launches, "step_s": statistics.median(steady)}


def phase_mla_train():
    """M1: single-pass RMNP training of deepseek-v2-lite-16b cut to 3 layers
    at full width (B=8, S=1024, bf16, seed 0): 3 timed steps with 13 apply
    launches each, tokens/s and peak memory; a second run from the same seed
    equals the first bit for bit after 2 steps; the per-leaf engine equals
    the single-pass one bit for bit on the expert stacks."""
    return train_cut("M1", "M1_train_deepseek_3_layers", m1_config(), DS_BUCKETS,
                     f"{M_ARCH} cut to {M1_LAYERS} layers (dense prefix + 2 MoE units), "
                     f"full width")


# Phase V: a predicted peak within this share of the measured one
V_MEM_TOL = 0.10


def dryrun_records():
    """Phase V's records, on meta tensors (launch/dryrun.py; nothing is
    built, allocated or run on the card): one step each of C1, S3's prefill
    and decode, and M1, and S3's whole served batch (launch/serve.generate
    as S3 calls it: the flash prefill, the cache of 1024 + 128 placed, the
    127 decode steps, with the parameters and prompts S3 holds at its reset
    as the window's arguments). start_dryrun runs it beside the phases on
    the card."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import param_specs

    torch.set_num_threads(1)
    single_pass = dict(opt_config=dict(fused=True, fused_apply=True), microbatches=1)
    s_cfg = dataclasses.replace(get_config(S_ARCH), attn_impl="pallas")
    steps = {
        "V1": dryrun.record(get_config("gpt2-small"), ShapeConfig("C1", 1024, 8, "train"),
                            **single_pass),
        "V2_prefill": dryrun.record(s_cfg, ShapeConfig("S3_prefill", S_PROMPT, S_BATCH,
                                                       "prefill")),
        "V2_decode": dryrun.record(s_cfg, ShapeConfig("S3_decode", S_PROMPT + S_TOKENS,
                                                      S_BATCH, "decode")),
        "V3": dryrun.record(m1_config(), ShapeConfig("M1", M1_SEQ, M1_BATCH, "train"),
                            **single_pass),
    }
    specs = param_specs(s_cfg)
    prompts = torch.empty((S_BATCH, S_PROMPT), dtype=torch.int64, device="meta")
    window = dryrun.record_window(generate, s_cfg, specs, prompts, S_TOKENS,
                                  arguments={"params": specs, "batch": prompts})
    return {"steps": steps, "window": window}


def start_dryrun():
    """(pool, future) of dryrun_records in a spawned process of its own
    (meta tensors only, one CPU thread), so that its recording (about 35 s
    of host time) runs beside the phases on the card and phase V only
    waits for what is left of it. The pool is shut down after V, or at
    exit."""
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    return pool, pool.submit(dryrun_records)


def phase_dryrun(pending=None):
    """V: the dry run of C1, S3 and M1 (dryrun_records, from ``pending``,
    start_dryrun's future, or recorded here) against their measured peaks.

    Each window is the phase's own, from its reset_peak_memory_stats() to
    its max_memory_allocated(): V1 C1's train() (the parameters, state and
    batch it makes, and its steps: one record of gpt2-small's single-pass
    step, B=8, S=1024, remat="full"), V2 S3's served batch, V3 M1's steps
    (deepseek-v2-lite-16b cut to 3 layers). The predicted peak is the dry
    run's peak (its arguments in it) plus what the phase held at its reset
    beyond those arguments (read there: held_at_reset_gb). Two gates: the
    predicted peak within V_MEM_TOL of the measured one, and the dry run's
    rise over its held arguments within V_MEM_TOL of the measured rise over
    what the phase held. Beside them, per step (V1, S3's prefill and decode,
    V3): its FLOPs and model_flops, and the measured time over the record's
    roofline bound (reported, not gated)."""
    from repro_torch.launch.roofline import roofline_row

    gib = 2**30
    card = card_name()
    c1 = RESULTS["C1_train_single_pass"]
    s3 = RESULTS["S_serve_" + S_ARCH.replace("-", "_").replace(".", "_")]
    m1 = RESULTS["M1_train_deepseek_3_layers"]
    wait0 = time.perf_counter()
    recs = dryrun_records() if pending is None else pending.result(timeout=900)
    waited = time.perf_counter() - wait0
    steps, window = recs["steps"], recs["window"]
    record_s = window["record_s"] + sum(r["record_s"] for r in steps.values())

    # label: (the dry run's memory, the phase's record, its arguments that
    # the phase already held at its reset)
    windows = {"V1": (steps["V1"]["memory"], c1, 0),
               "V2": (window["memory"], s3, window["memory"]["argument_bytes"]),
               "V3": (steps["V3"]["memory"], m1, 0)}
    out = {"card": card, "tolerance": V_MEM_TOL, "record_s": record_s,
           "V2_record_s": window["record_s"], "waited_s": waited,
           "beside_the_card": pending is not None}
    print(f"V: the dry run recorded in {record_s:.1f} s "
          f"{'beside the phases on the card' if pending is not None else 'here'}; "
          f"V waited {waited:.1f} s for it", flush=True)
    failed = []
    for label, (mem, phase, args_held) in windows.items():
        held = phase["held_at_reset_gb"]
        beyond = held - args_held / gib
        peak = mem["bytes_per_device"] / gib
        predicted, measured = beyond + peak, phase["peak_mem_gb"]
        rise, rise_measured = peak - args_held / gib, measured - held
        ratio, rise_ratio = predicted / measured, rise / rise_measured
        out[label] = {
            "predicted_peak_gb": predicted, "measured_peak_gb": measured, "ratio": ratio,
            "held_at_reset_gb": held, "held_beyond_arguments_gb": beyond,
            "dryrun_peak_gb": peak, "dryrun_arguments_gb": mem["argument_bytes"] / gib,
            "predicted_rise_gb": rise, "measured_rise_gb": rise_measured,
            "rise_ratio": rise_ratio, "at_peak": mem["at_peak"],
            "makers_at_peak": mem["makers_at_peak"]}
        print(f"{label} ({card}): predicted peak {predicted:.3f} GiB (held beyond the "
              f"arguments {beyond:.3f} + dry run {peak:.3f}, of it arguments "
              f"{mem['argument_bytes'] / gib:.3f}), measured {measured:.3f} GiB, ratio "
              f"{ratio:.4f}; rise over the held arguments predicted {rise:.3f} GiB, "
              f"measured {rise_measured:.3f}, ratio {rise_ratio:.4f}", flush=True)
        for what, r in (("peak", ratio), ("rise", rise_ratio)):
            if abs(r - 1) > V_MEM_TOL:
                failed.append(f"{label} {what}: ratio {r:.4f}")

    measured_s = {"V1": statistics.median(c1["step_s"][1:]),
                  "V2_prefill": s3["prefill_ms"]["pallas"]["median"] / 1e3,
                  "V2_decode": s3["decode_ms_per_step"]["median"] / 1e3,
                  "V3": statistics.median(m1["step_s"][1:])}
    out["steps"] = {}
    for label, rec in steps.items():
        row = roofline_row(dict(rec, cell=label))
        bound = max(row["t_compute_s"], row["t_memory_s"], row["t_collective_s"])
        seconds = measured_s[label]
        out["steps"][label] = {
            "flops": rec["cost"]["flops"], "model_flops": rec["model_flops"],
            "flops_by_unit": rec["cost"]["flops_by_unit"],
            "bytes_accessed": rec["cost"]["bytes_accessed"], "roofline_bound_s": bound,
            "bound_by": row["dominant"], "measured_s": seconds,
            "roofline_share": bound / seconds,
            "kernel_launches": rec["cost"]["kernel_launches"], "record_s": rec["record_s"]}
        print(f"{label} step ({card}): FLOPs {rec['cost']['flops']:.4e} beside model_flops "
              f"{rec['model_flops']:.4e}; measured {seconds * 1e3:.2f} ms over a bound of "
              f"{bound * 1e3:.2f} ms ({row['dominant']}): {bound / seconds:.3f} of the "
              f"roofline", flush=True)
    emit("V_dryrun", out)
    check(not failed, f"V: predictions outside {V_MEM_TOL:.0%} of the measured: {failed}")


def phase_yi_train():
    """Y2: yi-9b cut to layers 0:2 at full width (870,338,560 parameters),
    trained as M1 (6 apply launches a step, the untied 64000-row embedding
    and head among the buckets), two runs bit for bit."""
    return train_cut("Y2", "Y2_train_yi_9b_2_layers", cut_config(Y_ARCH), YI_BUCKETS,
                     f"{Y_ARCH} cut to layers {CUT_LAYERS}, full width")


def phase_olmoe_train():
    """O2: olmoe-1b-7b cut to layers 0:2 at full width (2 MoE units of 64
    experts, top-8; 1,045,703,168 parameters), trained as M1 (5 apply
    launches a step, the expert stacks at L = 128), two runs bit for bit,
    per-leaf against single-pass on the expert stacks."""
    return train_cut("O2", "O2_train_olmoe_2_layers", cut_config(O_ARCH), O_BUCKETS,
                     f"{O_ARCH} cut to layers {CUT_LAYERS} (2 MoE units), full width")


@contextlib.contextmanager
def routing(moe, record=None, replay=None):
    """Patch the MoE router for the block: ``record`` (a list) receives each
    call's expert ids; ``replay`` (an iterator of expert ids) replaces each
    call's choice, the gates then taken from this run's own probabilities
    at those experts and renormalized, as ``moe._route`` does."""
    import torch
    route = moe._route

    def patched(cfg_, p, xf):
        gates, ids, aux = route(cfg_, p, xf)
        if replay is not None:
            ids = next(replay)
            probs = torch.softmax((xf @ p["router"]).float(), dim=-1)
            gates = torch.gather(probs, -1, ids)
            gates = gates / (torch.sum(gates, dim=-1, keepdim=True) + 1e-9)
        if record is not None:
            record.append(ids)
        return gates, ids, aux
    moe._route = patched
    try:
        yield
    finally:
        moe._route = route


def routing_agreement(a, b, n_experts):
    """The share of (token, layer, k) routings on which two runs agree:
    as sets (an expert chosen by both for the token) and by rank k."""
    import torch
    same_set = same_rank = total = 0
    for x, y in zip(a, b, strict=True):
        hx = torch.nn.functional.one_hot(x, n_experts).sum(-2)
        hy = torch.nn.functional.one_hot(y, n_experts).sum(-2)
        same_set += int(torch.minimum(hx, hy).sum())
        same_rank += int((x == y).sum())
        total += x.numel()
    return {"as_sets": same_set / total, "by_rank": same_rank / total, "routings": total,
            "per_layer_as_sets": [float(torch.minimum(
                torch.nn.functional.one_hot(x, n_experts).sum(-2),
                torch.nn.functional.one_hot(y, n_experts).sum(-2)).sum()) / x.numel()
                for x, y in zip(a, b, strict=True)]}


def serve_moe(arch, tag, record_name, n_params_want, control_factor=M_CONTROL_FACTOR,
              reading_factor=None):
    """M2: serving deepseek-v2-lite-16b at full width and depth (bf16, seed 0,
    B=8, T=1024, 128 new tokens, S_max=1152) through launch/serve.serve: the
    timed run at the config's capacity factor (flash prefill, 27 launches
    counted), prefill ms with flash and with dense attention, decode ms a
    step, tokens/s, init time and peak, serving peak; then at capacity
    factor E / K, with the reference run's routing replayed, the flash
    prefill against the dense one with a non-causal control, and decode
    against a teacher-forced dense forward with decoding at pos + 1 as the
    control; with free routing the same distances and the share of
    routings on which the flash and dense prefills agree, reported. O runs
    the same for olmoe-1b-7b (``arch``; ``tag`` names the phase in its
    messages, ``record_name`` its record; the parameter count must be
    ``n_params_want``). Each control must land ``control_factor`` times
    outside M_LOGIT_TOL and, with ``reading_factor``, that many times past
    the reading it controls."""
    import torch
    from repro_torch.core.types import tree_paths
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import generate, place_cache, serve
    from repro_torch.models import init_params, layers, moe
    from repro_torch.models.model import forward, init_cache, lm_head
    from repro_torch.train.step import make_prefill_step, make_serve_step
    from repro_torch.configs import get_config

    base = get_config(arch)
    # the fp32 noise of the expert stack (38.4 GB for deepseek, 25.8 GB for
    # olmoe) needs one free block: earlier phases' reference cycles
    # (autograd graphs) are collected and the allocator's cache returned first
    gc.collect()
    torch.cuda.empty_cache()
    held_gb = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(base, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for _, t in tree_paths(params))
    check(n_params == n_params_want, f"{tag}: {n_params} parameters, want {n_params_want}")
    prompts = torch.randint(0, base.vocab, (M_BATCH, M_PROMPT), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
    real = slice(0, base.vocab)

    def rel(a, b):
        a, b = a[..., real].float(), b[..., real].float()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    # the timed run: a short warm-up, then the served batch, which keeps no
    # logits, so its peak (generate resets it after init) is serving's own
    serve(arch, full=True, batch=M_BATCH, prompt_len=M_PROMPT, tokens=4,
          attn_impl="pallas", params=params, prompts=prompts)
    torch.cuda.empty_cache()
    reset_launches()
    res = serve(arch, full=True, batch=M_BATCH, prompt_len=M_PROMPT, tokens=M_TOKENS,
                attn_impl="pallas", params=params, prompts=prompts)
    serve_launches = LAUNCHES["flash_attention_fwd"]
    check(serve_launches == base.num_layers,
          f"{tag}: {serve_launches} flash launches in a served batch, want {base.num_layers}")
    seqs = res["tokens"]
    check(seqs.shape == (M_BATCH, M_TOKENS) and int(seqs.min()) >= 0
          and int(seqs.max()) < base.vocab, f"{tag}: generated tokens {seqs.shape}")

    # prefill ms per attention mode at the config's capacity factor
    batch = {"tokens": prompts}
    prefill_ms = {}
    for run in ("pallas", "dense"):
        step = make_prefill_step(dataclasses.replace(base, attn_impl=run))
        prefill_ms[run] = per_call_ms(lambda st=step: st(params, batch), iters=5, warmup=1)
        torch.cuda.empty_cache()

    # The checks, at capacity factor E / K (nothing dropped). A near tie in
    # the router's top-K falls either way under bf16 rounding, and a flipped
    # expert changes that token's output by about 1/K of its routed part
    # (the experts are independent random functions), so two runs that round
    # differently drift apart through the layers by more than qwen3's dense
    # layers do. Each comparison is therefore made twice: with free routing
    # (reported, with the share of routings that agree) and with the
    # routing of the reference run replayed into the other (gated), which
    # leaves only the attention's and the stack's own rounding between them.
    m = base.moe
    nodrop = dataclasses.replace(base, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    dense_attention = layers.attention

    def prefill(run, record=None, replay=None):
        cfg = dataclasses.replace(nodrop, attn_impl="dense" if run == "control" else run)
        with routing(moe, record, replay):
            if run == "control":
                layers.attention = lambda q, k, v, causal=True, **kw: dense_attention(
                    q, k, v, False, **kw)
            try:
                reset_launches()
                last = make_prefill_step(cfg)(params, batch)[0]
            finally:
                layers.attention = dense_attention
        return last, LAUNCHES["flash_attention_fwd"]

    dense_routes, flash_routes = [], []
    last, launches = {}, {}
    last["dense"], launches["dense"] = prefill("dense", record=dense_routes)
    last["pallas_free"], launches["pallas"] = prefill("pallas", record=flash_routes)
    last["pallas"], _ = prefill("pallas", replay=iter(dense_routes))
    last["control"], launches["control"] = prefill("control", replay=iter(dense_routes))
    torch.cuda.empty_cache()
    check(launches == {"pallas": base.num_layers, "dense": 0, "control": 0},
          f"{tag}: flash launches per prefill {launches}")
    s1, s1_control = rel(last["pallas"], last["dense"]), rel(last["control"], last["dense"])
    s1_free = rel(last["pallas_free"], last["dense"])
    agree = routing_agreement(flash_routes, dense_routes, m.num_experts)
    del flash_routes, last

    # decode against a teacher-forced dense forward over the prompt and the
    # first M_FORCED generated tokens (a served batch at capacity factor
    # E / K makes them): the same step functions as serving, once with free
    # routing and once with the forced forward's routing replayed, and the
    # control decoding one position late
    checked = generate(dataclasses.replace(nodrop, attn_impl="pallas"), params, prompts,
                       M_FORCED + 1, keep_logits=True)
    cseqs = checked["tokens"]
    free_got = torch.stack(checked["logits"][1:M_FORCED + 1], dim=1)
    del checked
    dense_cfg = dataclasses.replace(nodrop, attn_impl="dense")
    forced = torch.cat([prompts, cseqs[:, :M_FORCED].long()], dim=1)
    forced_routes = []
    with torch.no_grad(), routing(moe, record=forced_routes):
        hidden = forward(dense_cfg, params, {"tokens": forced}, "train", return_hidden=True)[0]
        want = hidden[:, M_PROMPT:M_PROMPT + M_FORCED] @ lm_head(base, params)
    del hidden
    s2_free = rel(free_got, want)
    del free_got
    # the forced routing per token position: (B, T + F, K) a layer
    by_pos = [r.reshape(M_BATCH, M_PROMPT + M_FORCED, -1) for r in forced_routes]
    del forced_routes
    serve_step = make_serve_step(dense_cfg)

    def forced_decode(shift):
        prompt_ids = [r[:, :M_PROMPT].reshape(1, M_BATCH * M_PROMPT, -1) for r in by_pos]
        with routing(moe, replay=iter(prompt_ids)):
            _, pc = make_prefill_step(dense_cfg)(params, batch)
        cache = place_cache(init_cache(dense_cfg, M_BATCH, M_PROMPT + M_FORCED + 2,
                                       device="cuda"), pc)
        del pc
        out = []
        for i in range(M_FORCED):
            step_ids = [r[:, M_PROMPT + i][None] for r in by_pos]
            with routing(moe, replay=iter(step_ids)):
                _, lg, cache = serve_step(params, cache, cseqs[:, i:i + 1],
                                          M_PROMPT + i + shift)
            out.append(lg[:, 0])
        return torch.stack(out, dim=1)

    s2, s2_control = rel(forced_decode(0), want), rel(forced_decode(1), want)
    del want, by_pos
    torch.cuda.empty_cache()

    decode = res["decode_ms"]

    def summary(xs):
        return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}

    card = card_name()
    record = {
        "card": card, "config": arch, "params": n_params, "batch": M_BATCH,
        "prompt_len": M_PROMPT, "new_tokens": M_TOKENS, "init_s": init_s,
        "held_before_init_gb": held_gb, "init_peak_gb": init_peak, "flash_launches_per_prefill": serve_launches,
        "prefill_ms": {run: summary(ms) for run, ms in prefill_ms.items()},
        "prefill_samples_ms": prefill_ms, "served_prefill_ms": res["prefill_ms"],
        "place_ms": res["place_ms"], "decode_ms_per_step": summary(decode),
        "decode_steps": len(decode), "decode_samples_ms": decode,
        "decode_tokens_per_s": res["decode_tokens_per_s"], "tokens_per_s": res["tokens_per_s"],
        "wall_s": res["wall_s"], "serving_peak_gb": res["peak_bytes"] / 2**30,
        "tokens_head": seqs[:, :8].tolist(), "checks_capacity_factor": nodrop.moe.capacity_factor,
        "logits_rel_flash_vs_dense": s1, "logits_rel_control_noncausal": s1_control,
        "logits_rel_decode_vs_forced": s2, "logits_rel_control_pos_plus_1": s2_control,
        "free_routing_logits_rel_flash_vs_dense": s1_free,
        "free_routing_logits_rel_decode_vs_forced": s2_free,
        "tolerance": M_LOGIT_TOL, "control_factor": control_factor,
        "control_reading_factor": reading_factor,
        "routing_agreement_flash_vs_dense": agree}
    emit(record_name, record)
    for run, ms in prefill_ms.items():
        sm = summary(ms)
        print(f"{tag} ({card}): prefill {run} {sm['median']:.2f} ms ({sm['min']:.2f}-"
              f"{sm['max']:.2f})", flush=True)
    d = summary(decode)
    print(f"{tag} ({card}): decode {d['median']:.3f} ms a step ({d['min']:.3f}-{d['max']:.3f}, "
          f"{len(decode)} steps), {res['decode_tokens_per_s']:.1f} decode tokens/s; init "
          f"{init_s:.1f} s, init peak {init_peak:.2f} GiB, serving peak "
          f"{record['serving_peak_gb']:.2f} GiB", flush=True)
    print(f"{tag} (routing replayed): flash vs dense {s1:.3e} (control {s1_control:.3e}); "
          f"decode vs forced {s2:.3e} (control {s2_control:.3e}); tolerance {M_LOGIT_TOL}",
          flush=True)
    print(f"{tag} (free routing): flash vs dense {s1_free:.3e}, decode vs forced {s2_free:.3e}; "
          f"routings agreeing {agree['as_sets']:.5f} as sets, {agree['by_rank']:.5f} by rank, "
          f"of {agree['routings']}", flush=True)
    check(s1 <= M_LOGIT_TOL, f"{tag}: flash prefill logits {s1} from dense > {M_LOGIT_TOL}")
    check(s2 <= M_LOGIT_TOL, f"{tag}: decode logits {s2} from the forced forward > {M_LOGIT_TOL}")
    for name, c, reading in (("non-causal prefill", s1_control, s1),
                             ("decoding at pos + 1", s2_control, s2)):
        check(c >= control_factor * M_LOGIT_TOL,
              f"{tag}: the control ({name}) is only {c} away, less than "
              f"{control_factor}x the tolerance {M_LOGIT_TOL}")
        if reading_factor is not None:
            check(c >= reading_factor * reading,
                  f"{tag}: the control ({name}) is only {c} away, less than "
                  f"{reading_factor}x the reading it controls ({reading})")
    del params, res, cseqs
    torch.cuda.empty_cache()
    return serve_launches


def phase_mla_serve():
    """M2: serving deepseek-v2-lite-16b whole (serve_moe)."""
    return serve_moe(M_ARCH, "M2", "M2_serve_deepseek_v2_lite", 15_706_484_224)


def phase_olmoe_serve():
    """O: serving olmoe-1b-7b at full width and depth (16 layers, H = K =
    16 at hd 128 with qk_norm, 64 experts top-8; 6,919,624,704 parameters)
    as M2 serves deepseek: 16 launches of the bf16 hd-128 kernel a prefill,
    at capacity factor E / K = 8 with the reference run's routing replayed
    the flash prefill against dense and decode against a forced forward,
    and free routing's agreement. Each control must land outside
    M_LOGIT_TOL, as S's do, and 4x past the reading it controls: olmoe's
    attention with random weights (qk_norm, H = K = 16 over 1024 keys) is
    near uniform, so decoding one position late moves its logits by only
    5.8e-2 (1.15x the tolerance) where deepseek's move 4.8x; the replayed
    reading is 8.6e-3, 6.7x below that control (PERF.md)."""
    return serve_moe(O_ARCH, "O", "O_serve_olmoe_1b_7b", 6_919_624_704,
                     control_factor=1.0, reading_factor=M_CONTROL_FACTOR)


# The SSM architectures (phases X1, X2, J1, J2). xlstm-350m runs whole;
# jamba-v0.1-52b's 51.6 B parameters (103 GB in bf16) do not fit one card,
# so it is cut in depth (configs.cut_layers), every width kept: J1 serves
# its first group of 8 layers (7 mamba and the GQA layer, the 16-expert
# top-2 MoE FFN on layers 1, 3, 5 and 7), J2 trains layers 3 and 4 (a
# mamba layer with the MoE FFN, then the GQA layer with its dense FFN).
X_ARCH = "xlstm-350m"
X_BATCH, X_SEQ, X1_STEPS = 8, 1024, 2
# X1 trains xlstm-350m cut in depth: each step of its 24 layers takes ~22 s
# of host-bound sLSTM loop on an H100, 230 s of the script's time limit for
# the whole phase (PERF.md); X2 serves it whole
X1_LAYERS = "0:12"
# X2 decodes F tokens against a forced forward over T + F = 1152, a multiple
# of the mLSTM chunk (128), so the forward runs the prefill's chunked scan
X_PROMPT, X_TOKENS, X_FORCED = 1024, 128, 128
J_ARCH = "jamba-v0.1-52b"
J1_LAYERS, J2_LAYERS = "0:8", "3:5"
# J1 forces T + F = 1088, a multiple of the mamba chunk (64)
J_BATCH, J_PROMPT, J_TOKENS, J_FORCED = 8, 1024, 128, 64
J2_BATCH, J2_SEQ, J2_STEPS = 8, 1024, 3
# X2 and J1 compare logits (and J1's flash prefill also the final hidden
# state over every position) by their relative Frobenius distance, as S and
# M2 do, under S's tolerance. The decode steps run each mixer's recurrence
# one token at a time where the forced forward runs the chunked scans
# (mLSTM's chunks of 128, mamba's doubling scan in chunks of 64) over the
# same tokens: the same sums in other orders, then the stack. The control
# decodes the same tokens from a zeroed cache (the prompt's state dropped)
# and must land outside the tolerance; for jamba also the non-causal
# prefill (its one GQA layer) against the flash one, by the hidden state:
# the last position attends to every token either way, so its logits
# barely move.
SSM_LOGIT_TOL = S_LOGIT_TOL
# xlstm-350m in bf16 drifts from its forced forward by about 0.1 over the
# decode steps in the JAX package as in the port, on the CPU as on the card
# (tests/_ssm_bf16_decode.py, PERF.md): the GEMMs of one token and of the
# whole sequence round differently in bf16, and the 24 recurrent layers
# carry each difference into every later token. X2 reports that reading
# and gates the same comparison in fp32 from the same weights (cast), where
# only fp32 sums in other orders remain: 1e-5 to 1e-4 of the logits; the
# bound leaves room for T = 1024 and 128 steps and stays 50x under S's.
X2_FP32_TOL = 1e-3


def device_profile(fn, top=10):
    """Run ``fn`` once under torch.profiler, device activity only: the sum
    of its kernels' (and copies') times, their number, and the names that
    take the most time. None where the profiler saw no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not ops:
        print("profiler: no device activity recorded", flush=True)
        return None
    by_name = {}
    for e in ops:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"kernel_ms": sum(us for _, us in by_name.values()) / 1e3,
            "launches": len(ops),
            "top": [{"name": n[:100], "calls": c, "ms": us / 1e3} for n, (c, us) in ranked]}


def idle_share(prof, wall_ms):
    """1 - device time / wall time of an unprofiled run of the same work
    (kernels on one stream do not overlap)."""
    return None if prof is None else 1.0 - prof["kernel_ms"] / wall_ms


def differing_on_card(host, tree):
    """``differing`` of a host copy against a tree still on the card, one
    leaf copied at a time (J2's state is 22 GB)."""
    from repro_torch.core.types import tree_paths
    live = tree_paths(tree)
    if [p for p, _ in host] != [p for p, _ in live]:
        return ["<tree structure>"]
    return [p for (p, x), (_, y) in zip(host, live, strict=True)
            if differing([(p, x)], [(p, y.detach().to("cpu"))])]


def ssm_train(arch, layers, steps, batch, seq, n_buckets, tag):
    """Two runs of ``launch.train.train`` (full width, single-pass RMNP,
    seed 0) of ``steps`` steps each, and one more step of the second run
    under the profiler. Returns the record's common part."""
    import torch
    from repro_torch.configs import cut_layers, get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.core.types import tree_paths
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.train.step import make_train_step

    cfg = get_config(arch)
    if layers:
        cfg = cut_layers(cfg, layers)
    kw = dict(reduced=False, layers=layers, optimizer="rmnp", fused=True, fused_apply=True,
              use_kernel=True, batch=batch, seq=seq, steps=steps, log_every=1, seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    params, state, hist = train(arch, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = LAUNCHES["rmnp_apply"]
    n_params = sum(t.numel() for _, t in tree_paths(params))
    buckets = {k: list(b.shape) for k, b in state.buckets.items()}
    first = host_copy((params, state.buckets))
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    params, state, hist2 = train(arch, **kw)
    diff = differing_on_card(first, (params, state.buckets))
    del first
    losses = [h["loss"] for h in hist]
    step_s = step_seconds(hist) + step_seconds(hist2)[1:]
    steady = step_seconds(hist)[1:] + step_seconds(hist2)[1:]
    check(all(math.isfinite(x) for x in losses), f"{tag} losses {losses}")
    check([h["launches"]["rmnp_apply"] for h in hist] == [n_buckets] * steps,
          f"{tag} apply launches per step {[h['launches'] for h in hist]}")
    check(len(buckets) == n_buckets, f"{tag} buckets {buckets}")
    # one more step of the second run under the profiler (device activity)
    opt = make_optimizer("rmnp", dict(lr_matrix=cosine_with_warmup(2e-3, steps),
                                      lr_adamw=cosine_with_warmup(1e-3, steps),
                                      fused=True, fused_apply=True))
    step_fn = make_train_step(cfg, opt, remat="full")
    extra = batch_to_device(make_stream(cfg, seq, batch, seed=0).sample(steps), "cuda")
    out = {}

    def one_step():
        out["new"] = step_fn(params, state, extra, steps)

    prof = device_profile(one_step)
    wall_ms = statistics.median(steady) * 1e3
    del out
    tokens = batch * seq
    rec = {"card": card_name(), "params": n_params, "batch": batch, "seq": seq,
           "losses": losses, "losses_second_run": [h["loss"] for h in hist2],
           "step_s": step_s, "step_s_median": statistics.median(steady),
           "tokens_per_s": tokens / statistics.median(steady), "peak_mem_gb": peak,
           "launches_per_step": [h["launches"] for h in hist], "buckets": buckets,
           "bitwise_equal_after_steps": not diff, "steps_compared": steps,
           "differing": diff[:20], "profile": prof, "idle_share": idle_share(prof, wall_ms)}
    check(not diff, f"{tag}: two runs from one seed differ after {steps} steps in {diff[:5]}")
    return rec, launches, params, cfg


def phase_xlstm_train():
    """X1: xlstm-350m cut to layers 0:12 at full width (6 layers each of
    alternating mLSTM and sLSTM, d = 1024, 4 heads, untied, bf16,
    285,891,632 parameters) trained with single-pass RMNP through
    launch.train.train (B=8, S=1024, seed 0): 2 timed steps with 7 apply
    launches each, tokens/s and peak
    memory; a second run equals the first bit for bit after its 2 steps;
    one more step under the profiler (device ops a step, idle share); and
    one sLSTM and one mLSTM layer alone at the step's shapes, forward,
    recompute and backward as the unit's checkpoint runs them: their device
    ops, 6 times over, against the step's give the share of the
    (host-bound) step that the sLSTM layers' loop over time takes."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models import ssm

    rec, launches, params, cfg = ssm_train(X_ARCH, X1_LAYERS, X1_STEPS, X_BATCH, X_SEQ,
                                           len(XLSTM_BUCKETS), "X1")
    check(rec["params"] == 285_891_632, f"X1: {rec['params']} parameters")
    check(sorted(rec["buckets"]) == sorted(f"{a}x{b}" for _, a, b in XLSTM_BUCKETS),
          f"X1 buckets {rec['buckets']}")
    # one layer of each kind alone at the step's shapes, as the unit's
    # checkpoint runs it (forward, recompute, backward): its device ops under
    # the profiler and its time on the host clock (2 runs, after the
    # profiled one). The step is host-bound, so the layers' share of its
    # device ops is their share of its time; 6 layers of each kind.
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((X_BATCH, X_SEQ, cfg.d_model), generator=gen, device="cuda").to(
        torch.bfloat16)
    ct = torch.randn(x.shape, generator=gen, device="cuda").to(torch.bfloat16)
    alone = {}
    for name, j, apply in (("slstm", 1, ssm.slstm_apply), ("mlstm", 0, ssm.mlstm_apply)):
        p = {k: t[0].detach().clone().requires_grad_(True)
             for k, t in params["stack"][f"layer_{j}"]["mixer"].items()}
        xin = x.clone().requires_grad_(True)

        def layer(p=p, xin=xin, apply=apply):
            y = checkpoint(lambda a: apply(cfg, p, a, None, "train")[0], xin,
                           use_reentrant=False)
            torch.autograd.grad(y, [xin, *p.values()], ct)

        lp = device_profile(layer)
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            layer()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        alone[name] = {"s": times, "device_ops": lp and lp["launches"],
                       "kernel_ms": lp and lp["kernel_ms"]}
        del p, xin
    del params
    torch.cuda.empty_cache()
    per_kind = cfg.num_layers // 2
    step = rec["step_s_median"]
    step_ops = (rec["profile"] or {}).get("launches")
    for name, a in alone.items():
        a["share_of_step_ops"] = (per_kind * a["device_ops"] / step_ops
                                  if step_ops and a["device_ops"] else None)
        a["alone_s_times_layers_over_step"] = per_kind * statistics.median(a["s"]) / step
    rec.update(config=f"{X_ARCH} cut to layers {X1_LAYERS}, full width", layers_alone=alone)
    emit("X1_train_xlstm_350m", rec)
    print(f"X1 ({rec['card']}): steps {[round(s, 3) for s in rec['step_s']]} s, "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak {rec['peak_mem_gb']:.2f} GiB, "
          f"{len(XLSTM_BUCKETS)} apply launches a step; {step_ops} device ops a step, idle "
          f"{rec['idle_share']}; the {per_kind} sLSTM layers "
          f"{alone['slstm']['share_of_step_ops']} of its device ops "
          f"({alone['slstm']['device_ops']} a layer, "
          f"{statistics.median(alone['slstm']['s']):.3f} s a layer alone), the {per_kind} "
          f"mLSTM layers {alone['mlstm']['share_of_step_ops']}", flush=True)
    return {"rmnp_apply": launches, "step_s": step}


def phase_jamba_train():
    """J2: jamba-v0.1-52b cut to layers 3 and 4 (a mamba layer with the
    16-expert top-2 MoE FFN, then the GQA layer with its dense FFN; full
    width, 3,678,941,184 parameters) trained with single-pass RMNP through
    launch.train.train (B=8, S=1024, bf16, seed 0): 3 timed steps with 10
    apply launches each (the expert stacks at L = 17), tokens/s, peak
    memory; a second run equals the first bit for bit; one more step under
    the profiler."""
    import torch
    rec, launches, params, _ = ssm_train(J_ARCH, J2_LAYERS, J2_STEPS, J2_BATCH, J2_SEQ,
                                         len(J2_BUCKETS), "J2")
    del params
    torch.cuda.empty_cache()
    check(rec["params"] == 3_678_941_184, f"J2: {rec['params']} parameters")
    check(sorted(rec["buckets"]) == sorted(f"{a}x{b}" for _, a, b in J2_BUCKETS),
          f"J2 buckets {rec['buckets']}")
    rec["config"] = f"{J_ARCH} cut to layers {J2_LAYERS} (mamba + MoE, GQA + dense), full width"
    emit("J2_train_jamba_2_layers", rec)
    prof = rec["profile"] or {}
    print(f"J2 ({rec['card']}): steps {[round(s, 3) for s in rec['step_s']]} s, "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak {rec['peak_mem_gb']:.2f} GiB, "
          f"{len(J2_BUCKETS)} apply launches a step; {prof.get('launches')} device ops a "
          f"step, idle {rec['idle_share']}", flush=True)
    return {"rmnp_apply": launches, "step_s": rec["step_s_median"]}


def summary_ms(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def forced_logits(cfg, params, prompts, seqs, n_forced, record=None):
    """A teacher-forced dense forward over the prompt and the first
    ``n_forced`` generated tokens: its logits at the positions whose tokens
    the decode steps produced (B, F, padded vocab)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models.model import forward, lm_head
    T = prompts.shape[1]
    forced = torch.cat([prompts, seqs[:, :n_forced].long()], dim=1)
    with torch.no_grad(), routing(moe, record=record):
        hidden = forward(cfg, params, {"tokens": forced}, "train", return_hidden=True)[0]
        return hidden[:, T:T + n_forced] @ lm_head(cfg, params)


def phase_xlstm_serve():
    """X2: serving xlstm-350m at full width (bf16, seed 0, B=8, T=1024, 128
    new tokens) through launch/serve.serve: prefill ms, decode ms a step,
    tokens/s, peak memory; a checked run's decode logits for 128 generated
    tokens against a teacher-forced forward over T + 128 tokens, in bf16
    (reported) and in fp32 from the same weights (gated at X2_FP32_TOL),
    each with the control decoding the same tokens from a zeroed cache; the
    prefill and 8 decode steps under the profiler."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_map, tree_paths
    from repro_torch.launch.serve import generate, place_cache, serve
    from repro_torch.models import init_params
    from repro_torch.models.model import init_cache
    from repro_torch.train.step import make_prefill_step, make_serve_step

    base = get_config(X_ARCH)
    gc.collect()
    torch.cuda.empty_cache()
    params = init_params(base, seed=0, device="cuda")
    n_params = sum(t.numel() for _, t in tree_paths(params))
    prompts = torch.randint(0, base.vocab, (X_BATCH, X_PROMPT), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
    real = slice(0, base.vocab)

    def rel(a, b):
        a, b = a[..., real].float(), b[..., real].float()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    serve(X_ARCH, full=True, batch=X_BATCH, prompt_len=X_PROMPT, tokens=4, params=params,
          prompts=prompts)
    torch.cuda.empty_cache()
    res = serve(X_ARCH, full=True, batch=X_BATCH, prompt_len=X_PROMPT, tokens=X_TOKENS,
                params=params, prompts=prompts)
    seqs = res["tokens"]
    check(seqs.shape == (X_BATCH, X_TOKENS) and int(seqs.min()) >= 0
          and int(seqs.max()) < base.vocab, f"X2: generated tokens {seqs.shape}")
    batch = {"tokens": prompts}
    prefill = make_prefill_step(base)
    prefill_ms = per_call_ms(lambda: prefill(params, batch), iters=2, warmup=0)

    checked = generate(base, params, prompts, X_FORCED + 1, keep_logits=True)
    cseqs = checked["tokens"]
    check(torch.equal(cseqs[:, :X_TOKENS], seqs), "X2: the checked run's tokens differ")
    serve_step = make_serve_step(base)
    check(all(torch.isfinite(x.float()).all().item() for x in checked["logits"]),
          "X2: non-finite logits")
    got = torch.stack(checked["logits"][1:X_FORCED + 1], dim=1)
    del checked
    want = forced_logits(base, params, prompts, cseqs, X_FORCED)
    s2 = rel(got, want)
    del got
    # the control: the same tokens decoded from a zeroed cache
    def zeroed_decode(cfg, p, tokens):
        step = make_serve_step(cfg)
        cache = init_cache(cfg, X_BATCH, X_PROMPT + X_FORCED + 1, device="cuda")
        out = []
        for i in range(X_FORCED):
            _, lg, cache = step(p, cache, tokens[:, i:i + 1], X_PROMPT + i)
            out.append(lg[:, 0])
        return torch.stack(out, dim=1)

    s2_control = rel(zeroed_decode(base, params, cseqs), want)
    del want
    # the same in fp32, from the same weights cast (matmuls without TF32)
    cfg32 = dataclasses.replace(base, dtype="float32")
    params32 = tree_map(lambda t: t.float(), params)
    checked32 = generate(cfg32, params32, prompts, X_FORCED + 1, keep_logits=True)
    cseqs32 = checked32["tokens"]
    got32 = torch.stack(checked32["logits"][1:X_FORCED + 1], dim=1)
    del checked32
    want32 = forced_logits(cfg32, params32, prompts, cseqs32, X_FORCED)
    s2_fp32 = rel(got32, want32)
    s2_fp32_control = rel(zeroed_decode(cfg32, params32, cseqs32), want32)
    del got32, want32, params32
    torch.cuda.empty_cache()

    # the prefill and 8 decode steps under the profiler
    state = {}

    def run_prefill():
        state["last"], state["pc"] = prefill(params, batch)

    prof_prefill = device_profile(run_prefill)
    cache = place_cache(init_cache(base, X_BATCH, X_PROMPT + 16, device="cuda"),
                        state.pop("pc"))
    tok = torch.argmax(state.pop("last")[:, :base.vocab], -1).to(torch.int32)[:, None]

    def run_decode():
        t = tok
        for i in range(8):
            t, _, _ = serve_step(params, cache, t, X_PROMPT + i)

    prof_decode = device_profile(run_decode)
    del cache
    decode = res["decode_ms"]
    card = card_name()
    record = {
        "card": card, "config": X_ARCH, "params": n_params, "batch": X_BATCH,
        "prompt_len": X_PROMPT, "new_tokens": X_TOKENS,
        "prefill_ms": summary_ms(prefill_ms), "prefill_samples_ms": prefill_ms,
        "served_prefill_ms": res["prefill_ms"], "place_ms": res["place_ms"],
        "decode_ms_per_step": summary_ms(decode), "decode_steps": len(decode),
        "decode_samples_ms": decode, "decode_tokens_per_s": res["decode_tokens_per_s"],
        "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
        "peak_mem_gb": res["peak_bytes"] / 2**30, "tokens_head": seqs[:, :8].tolist(),
        "bf16_logits_rel_decode_vs_forced": s2,
        "bf16_logits_rel_control_zeroed_cache": s2_control,
        "fp32_logits_rel_decode_vs_forced": s2_fp32,
        "fp32_logits_rel_control_zeroed_cache": s2_fp32_control,
        "fp32_tokens_equal_bf16_tokens": bool(torch.equal(cseqs32, cseqs)),
        "forced_tokens": X_FORCED, "tolerance_fp32": X2_FP32_TOL, "tolerance": SSM_LOGIT_TOL,
        "profile_prefill": prof_prefill,
        "idle_share_prefill": idle_share(prof_prefill, statistics.median(prefill_ms)),
        "profile_decode_8_steps": prof_decode,
        "idle_share_decode": idle_share(prof_decode, 8 * statistics.median(decode))}
    emit("X2_serve_xlstm_350m", record)
    p, d = summary_ms(prefill_ms), summary_ms(decode)
    print(f"X2 ({card}): prefill {p['median']:.2f} ms ({p['min']:.2f}-{p['max']:.2f}); decode "
          f"{d['median']:.3f} ms a step ({d['min']:.3f}-{d['max']:.3f}, {len(decode)} steps), "
          f"{res['decode_tokens_per_s']:.1f} decode tokens/s, peak "
          f"{record['peak_mem_gb']:.2f} GiB; idle prefill {record['idle_share_prefill']}, "
          f"decode {record['idle_share_decode']}", flush=True)
    print(f"X2: decode vs forced, bf16 {s2:.3e} (reported; zeroed-cache control "
          f"{s2_control:.3e}), fp32 {s2_fp32:.3e} (tolerance {X2_FP32_TOL}; control "
          f"{s2_fp32_control:.3e}, which must miss {SSM_LOGIT_TOL})", flush=True)
    check(s2_fp32 <= X2_FP32_TOL, f"X2: fp32 decode logits {s2_fp32} from the forced forward")
    for name, c in (("bf16", s2_control), ("fp32", s2_fp32_control)):
        check(c > SSM_LOGIT_TOL, f"X2: the {name} zeroed-cache control is only {c} away, "
                                 f"inside {SSM_LOGIT_TOL}")
    del params, res, cseqs
    torch.cuda.empty_cache()


def phase_jamba_serve():
    """J1: serving jamba-v0.1-52b cut to its first group of 8 layers (full
    width, 13,295,235,072 parameters, bf16, seed 0, B=8, T=1024, 128 new
    tokens) through launch/serve.serve with the flash prefill (one launch
    of the hd-128 kernel, its GQA layer, counted): init time and peak,
    prefill ms with flash and dense attention, decode ms a step, tokens/s,
    the serving peak; at capacity factor E / K with the reference run's
    routing replayed, as M2 does, the flash prefill against the dense one,
    by the last logits and the final hidden state (control: non-causal),
    and 64 decode steps against a teacher-forced forward (control: a zeroed
    cache); the prefill and 8 decode steps under the profiler."""
    import torch
    from repro_torch.configs import cut_layers, get_config
    from repro_torch.core.types import tree_paths
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import generate, place_cache, serve
    from repro_torch.models import init_params, layers, moe
    from repro_torch.models.model import forward, init_cache, lm_head
    from repro_torch.train.step import make_prefill_step, make_serve_step

    base = cut_layers(get_config(J_ARCH), J1_LAYERS)
    n_attn = sum(m == "gqa" for m, _ in base.pattern)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(base, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(t.numel() for _, t in tree_paths(params))
    check(n_params == 13_295_235_072, f"J1: {n_params} parameters")
    prompts = torch.randint(0, base.vocab, (J_BATCH, J_PROMPT), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(1))
    real = slice(0, base.vocab)

    def rel(a, b):
        a, b = a[..., real].float(), b[..., real].float()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    kw = dict(full=True, layers=J1_LAYERS, batch=J_BATCH, prompt_len=J_PROMPT,
              attn_impl="pallas", params=params, prompts=prompts)
    serve(J_ARCH, tokens=4, **kw)
    torch.cuda.empty_cache()
    reset_launches()
    res = serve(J_ARCH, tokens=J_TOKENS, **kw)
    serve_launches = LAUNCHES["flash_attention_fwd"]
    check(serve_launches == n_attn,
          f"J1: {serve_launches} flash launches in a served batch, want {n_attn}")
    seqs = res["tokens"]
    check(seqs.shape == (J_BATCH, J_TOKENS) and int(seqs.min()) >= 0
          and int(seqs.max()) < base.vocab, f"J1: generated tokens {seqs.shape}")
    batch = {"tokens": prompts}
    prefill_ms = {}
    for run in ("pallas", "dense"):
        step = make_prefill_step(dataclasses.replace(base, attn_impl=run))
        prefill_ms[run] = per_call_ms(lambda st=step: st(params, batch), iters=2, warmup=0)
        torch.cuda.empty_cache()

    m = base.moe
    nodrop = dataclasses.replace(base, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))
    dense_attention = layers.attention

    def prefill(run, record=None, replay=None):
        """The prefill step's work through ``forward``: (the final hidden
        state (B, T, d), the last position's logits, flash launches)."""
        cfg = dataclasses.replace(nodrop, attn_impl="dense" if run == "control" else run)
        with torch.no_grad(), routing(moe, record, replay):
            if run == "control":
                layers.attention = lambda q, k, v, causal=True, **kw: dense_attention(
                    q, k, v, False, **kw)
            try:
                reset_launches()
                hidden = forward(cfg, params, batch, "prefill", return_hidden=True)[0]
            finally:
                layers.attention = dense_attention
        return hidden, hidden[:, -1] @ lm_head(cfg, params), LAUNCHES["flash_attention_fwd"]

    dense_routes, flash_routes = [], []
    hid, last, launches = {}, {}, {}
    hid["dense"], last["dense"], launches["dense"] = prefill("dense", record=dense_routes)
    _, last["pallas_free"], launches["pallas"] = prefill("pallas", record=flash_routes)
    hid["pallas"], last["pallas"], _ = prefill("pallas", replay=iter(dense_routes))
    hid["control"], last["control"], launches["control"] = prefill(
        "control", replay=iter(dense_routes))
    torch.cuda.empty_cache()
    check(launches == {"pallas": n_attn, "dense": 0, "control": 0},
          f"J1: flash launches per prefill {launches}")
    s1, s1_logits_control = (rel(last["pallas"], last["dense"]),
                             rel(last["control"], last["dense"]))
    s1_free = rel(last["pallas_free"], last["dense"])

    def rel_hidden(a, b):
        a, b = a.float(), b.float()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    h1, s1_control = rel_hidden(hid["pallas"], hid["dense"]), rel_hidden(hid["control"],
                                                                          hid["dense"])
    agree = routing_agreement(flash_routes, dense_routes, m.num_experts)
    del flash_routes, dense_routes, last, hid

    checked = generate(dataclasses.replace(nodrop, attn_impl="pallas"), params, prompts,
                       J_FORCED + 1, keep_logits=True)
    cseqs = checked["tokens"]
    free_got = torch.stack(checked["logits"][1:J_FORCED + 1], dim=1)
    del checked
    dense_cfg = dataclasses.replace(nodrop, attn_impl="dense")
    forced_routes = []
    want = forced_logits(dense_cfg, params, prompts, cseqs, J_FORCED, record=forced_routes)
    s2_free = rel(free_got, want)
    del free_got
    by_pos = [r.reshape(J_BATCH, J_PROMPT + J_FORCED, -1) for r in forced_routes]
    del forced_routes
    serve_step = make_serve_step(dense_cfg)

    def forced_decode(zeroed):
        cache = init_cache(dense_cfg, J_BATCH, J_PROMPT + J_FORCED + 2, device="cuda")
        if not zeroed:
            prompt_ids = [r[:, :J_PROMPT].reshape(1, J_BATCH * J_PROMPT, -1) for r in by_pos]
            with routing(moe, replay=iter(prompt_ids)):
                _, pc = make_prefill_step(dense_cfg)(params, batch)
            cache = place_cache(cache, pc)
            del pc
        out = []
        for i in range(J_FORCED):
            step_ids = [r[:, J_PROMPT + i][None] for r in by_pos]
            with routing(moe, replay=iter(step_ids)):
                _, lg, cache = serve_step(params, cache, cseqs[:, i:i + 1], J_PROMPT + i)
            out.append(lg[:, 0])
        return torch.stack(out, dim=1)

    s2, s2_control = rel(forced_decode(False), want), rel(forced_decode(True), want)
    del want, by_pos
    torch.cuda.empty_cache()

    # the prefill (flash, the config's capacity factor) and 8 decode steps
    # under the profiler
    flash = dataclasses.replace(base, attn_impl="pallas")
    state = {}
    fstep, dstep = make_prefill_step(flash), make_serve_step(flash)

    def run_prefill():
        state["last"], state["pc"] = fstep(params, batch)

    prof_prefill = device_profile(run_prefill)
    cache = place_cache(init_cache(flash, J_BATCH, J_PROMPT + 16, device="cuda"),
                        state.pop("pc"))
    tok = torch.argmax(state.pop("last")[:, :base.vocab], -1).to(torch.int32)[:, None]

    def run_decode():
        t = tok
        for i in range(8):
            t, _, _ = dstep(params, cache, t, J_PROMPT + i)

    prof_decode = device_profile(run_decode)
    del cache
    decode = res["decode_ms"]
    card = card_name()
    record = {
        "card": card, "config": f"{J_ARCH} cut to layers {J1_LAYERS} (7 mamba + 1 GQA, MoE "
        f"on layers 1, 3, 5, 7), full width", "params": n_params, "batch": J_BATCH,
        "prompt_len": J_PROMPT, "new_tokens": J_TOKENS, "init_s": init_s,
        "init_peak_gb": init_peak, "flash_launches_per_prefill": serve_launches,
        "prefill_ms": {run: summary_ms(ms) for run, ms in prefill_ms.items()},
        "prefill_samples_ms": prefill_ms, "served_prefill_ms": res["prefill_ms"],
        "place_ms": res["place_ms"], "decode_ms_per_step": summary_ms(decode),
        "decode_steps": len(decode), "decode_samples_ms": decode,
        "decode_tokens_per_s": res["decode_tokens_per_s"], "tokens_per_s": res["tokens_per_s"],
        "wall_s": res["wall_s"], "serving_peak_gb": res["peak_bytes"] / 2**30,
        "tokens_head": seqs[:, :8].tolist(),
        "checks_capacity_factor": nodrop.moe.capacity_factor,
        "logits_rel_flash_vs_dense": s1, "logits_rel_control_noncausal": s1_logits_control,
        "hidden_rel_flash_vs_dense": h1, "hidden_rel_control_noncausal": s1_control,
        "logits_rel_decode_vs_forced": s2, "logits_rel_control_zeroed_cache": s2_control,
        "free_routing_logits_rel_flash_vs_dense": s1_free,
        "free_routing_logits_rel_decode_vs_forced": s2_free, "forced_tokens": J_FORCED,
        "tolerance": SSM_LOGIT_TOL, "routing_agreement_flash_vs_dense": agree,
        "profile_prefill": prof_prefill,
        "idle_share_prefill": idle_share(prof_prefill,
                                         statistics.median(prefill_ms["pallas"])),
        "profile_decode_8_steps": prof_decode,
        "idle_share_decode": idle_share(prof_decode, 8 * statistics.median(decode))}
    emit("J1_serve_jamba_8_layers", record)
    for run, ms in prefill_ms.items():
        sm = summary_ms(ms)
        print(f"J1 ({card}): prefill {run} {sm['median']:.2f} ms ({sm['min']:.2f}-"
              f"{sm['max']:.2f})", flush=True)
    d = summary_ms(decode)
    print(f"J1 ({card}): decode {d['median']:.3f} ms a step ({d['min']:.3f}-{d['max']:.3f}, "
          f"{len(decode)} steps), {res['decode_tokens_per_s']:.1f} decode tokens/s; init "
          f"{init_s:.2f} s, init peak {init_peak:.2f} GiB, serving peak "
          f"{record['serving_peak_gb']:.2f} GiB; idle prefill {record['idle_share_prefill']}, "
          f"decode {record['idle_share_decode']}", flush=True)
    print(f"J1 (routing replayed): flash vs dense, last logits {s1:.3e} (non-causal "
          f"{s1_logits_control:.3e}), hidden state {h1:.3e} (non-causal control "
          f"{s1_control:.3e}); decode vs forced {s2:.3e} (zeroed-cache control "
          f"{s2_control:.3e}); free routing {s1_free:.3e} and {s2_free:.3e}, routings "
          f"agreeing {agree['as_sets']:.5f} as sets; tolerance {SSM_LOGIT_TOL}", flush=True)
    check(s1 <= SSM_LOGIT_TOL, f"J1: flash prefill logits {s1} from dense")
    check(h1 <= SSM_LOGIT_TOL, f"J1: flash prefill hidden state {h1} from dense")
    check(s2 <= SSM_LOGIT_TOL, f"J1: decode logits {s2} from the forced forward")
    for name, c in (("non-causal prefill", s1_control), ("zeroed cache", s2_control)):
        check(c > SSM_LOGIT_TOL, f"J1: the control ({name}) is only {c} away, inside "
                                 f"the tolerance {SSM_LOGIT_TOL}")
    del params, res, cseqs
    torch.cuda.empty_cache()
    return serve_launches


P_ARCH, G_ARCH = "paligemma-3b", "musicgen-large"
# Phases P and G serve each frontend model at full width and depth as phase
# S serves qwen3-4b (B requests of a T-position prompt, N new tokens, the
# first F teacher-forced) and train it whole as J2 trains jamba's cut (both
# fit 80 GB at full depth: 53.98 and 51.25 GiB at peak, PERF.md)
F_BATCH, F_PROMPT, F_TOKENS, F_FORCED = 8, 1024, 128, 16
F_TRAIN_BATCH, F_TRAIN_SEQ, F_TRAIN_STEPS = 8, 1024, 2
# P1/P2 and G1/G2 hold the flash prefill against the dense one and decode
# against a teacher-forced dense forward under S's tolerance, for S's
# reasons (bf16 rounding carried through 18 and 48 layers); each control (a
# non-causal prefill; decoding at pos + 1) must land outside it.
F_LOGIT_TOL = S_LOGIT_TOL


def forced_batch(cfg, params, prompt, generated):
    """The prompt batch with the generated tokens appended, for a
    teacher-forced forward: paligemma's tokens (its image embeddings kept
    in front); musicgen's frames followed by the generated tokens' own
    embeddings, since a forward given frames reads nothing else, and that
    is what its decode steps embedded."""
    import torch
    if cfg.frontend == "audio_frames":
        frames = prompt["frames"].to(params["embed"]["tokens"].dtype)
        return {"frames": torch.cat([frames, params["embed"]["tokens"][generated.long()]], 1)}
    return {"tokens": torch.cat([prompt["tokens"], generated.long()], dim=1),
            "vision_embeds": prompt["vision_embeds"]}


def frontend_serve(arch, tag):
    """Serve ``arch`` at full width and depth (bf16, seed 0, F_BATCH
    requests of F_PROMPT positions, F_TOKENS new tokens) through
    launch/serve.serve with a prompt batch that carries its frontend array
    (``prompt_batch``, seed 1). <tag>1 the flash prefill (one launch a layer,
    counted) against the dense one, with the non-causal control; <tag>2 the
    first F_FORCED decode steps' logits against a teacher-forced dense
    forward over the same frontend input, with the pos + 1 control; <tag>3
    prefill ms per mode, decode ms a step, tokens per second, peak memory.
    Returns the flash launches of a served batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.types import tree_paths
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.serve import place_cache, prompt_batch, serve
    from repro_torch.models import init_params, layers
    from repro_torch.models.model import forward, init_cache, lm_head
    from repro_torch.train.step import make_prefill_step, make_serve_step

    base = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(base, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = prompt_batch(base, F_BATCH, F_PROMPT, 1, "cuda")
    n_params = sum(t.numel() for _, t in tree_paths(params))
    real = slice(0, base.vocab)

    def rel(a, b):
        a, b = a[..., real].float(), b[..., real].float()
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    common = dict(full=True, batch=F_BATCH, prompt_len=F_PROMPT, attn_impl="pallas",
                  params=params, prompts=prompt)
    serve(arch, tokens=4, **common)
    runs = {}
    for run, keep in (("timed", False), ("checked", True)):
        torch.cuda.empty_cache()
        reset_launches()
        runs[run] = serve(arch, tokens=F_TOKENS, keep_logits=keep, **common)
        launches = LAUNCHES["flash_attention_fwd"]
        check(launches == base.num_layers,
              f"{tag} ({run}): {launches} flash launches in a served batch, "
              f"want {base.num_layers}")
    checked, res = runs["checked"], runs["timed"]
    del runs
    seqs = checked["tokens"]
    check(seqs.shape == (F_BATCH, F_TOKENS) and int(seqs.min()) >= 0
          and int(seqs.max()) < base.vocab, f"{tag}: generated tokens {seqs.shape}")
    check(torch.equal(seqs, res["tokens"]),
          f"{tag}: the checked run's tokens differ from the timed run's")
    check(all(torch.isfinite(x.float()).all().item() for x in checked["logits"]),
          f"{tag}: non-finite logits")

    # <tag>1: the prefill in each mode from the same parameters and prompt
    dense_attention = layers.attention
    last, prefill_ms, launches = {}, {}, {}
    for run in ("pallas", "dense", "control"):
        cfg = dataclasses.replace(base, attn_impl="dense" if run == "control" else run)
        step = make_prefill_step(cfg)
        if run == "control":
            layers.attention = lambda q, k, v, causal=True, **kw: dense_attention(
                q, k, v, False, **kw)
        try:
            reset_launches()
            last[run] = step(params, prompt)[0]
            launches[run] = LAUNCHES["flash_attention_fwd"]
            if run != "control":
                prefill_ms[run] = per_call_ms(lambda st=step: st(params, prompt), iters=5,
                                              warmup=1)
        finally:
            layers.attention = dense_attention
        torch.cuda.empty_cache()
    check(launches == {"pallas": base.num_layers, "dense": 0, "control": 0},
          f"{tag}1: flash launches per prefill {launches}")
    p1 = rel(last["pallas"], last["dense"])
    p1_control = rel(last["control"], last["dense"])
    agree = float((last["pallas"][:, real].argmax(-1) == last["dense"][:, real].argmax(-1))
                  .float().mean())
    check(torch.equal(last["pallas"], checked["logits"][0]),
          f"{tag}1: the served prefill's logits differ from the prefill step's")

    # <tag>2: teacher-force the prompt and the first F_FORCED generated tokens
    dense_cfg = dataclasses.replace(base, attn_impl="dense")
    with torch.no_grad():
        hidden = forward(dense_cfg, params, forced_batch(base, params, prompt,
                                                         seqs[:, :F_FORCED]),
                         "train", return_hidden=True)[0]
        want = hidden[:, F_PROMPT:F_PROMPT + F_FORCED] @ lm_head(base, params)
    del hidden
    got = torch.stack(checked["logits"][1:F_FORCED + 1], dim=1)
    p2 = rel(got, want)
    _, pc = make_prefill_step(dense_cfg)(params, prompt)
    cache = place_cache(init_cache(dense_cfg, F_BATCH, F_PROMPT + F_TOKENS + 1,
                                   device="cuda"), pc)
    del pc
    serve_step = make_serve_step(dense_cfg)
    shifted = []
    for i in range(F_FORCED):
        _, lg, cache = serve_step(params, cache, seqs[:, i:i + 1], F_PROMPT + i + 1)
        shifted.append(lg[:, 0])
    p2_control = rel(torch.stack(shifted, dim=1), want)
    del cache, shifted, want, got, checked
    torch.cuda.empty_cache()

    decode = res["decode_ms"]
    card = card_name()
    record = {
        "card": card, "config": f"{arch}, full width and depth", "params": n_params,
        "batch": F_BATCH, "prompt_len": F_PROMPT, "new_tokens": F_TOKENS,
        "frontend": {k: list(v.shape) for k, v in prompt.items()}, "init_s": init_s,
        f"{tag}1_logits_rel_flash_vs_dense": p1, f"{tag}1_logits_rel_control": p1_control,
        f"{tag}1_greedy_agreement": agree, f"{tag}2_logits_rel_decode_vs_forced": p2,
        f"{tag}2_logits_rel_control": p2_control, "tolerance": F_LOGIT_TOL,
        "flash_launches_per_prefill": launches["pallas"],
        "prefill_ms": {run: summary_ms(ms) for run, ms in prefill_ms.items()},
        "prefill_samples_ms": prefill_ms,
        "served_prefill_ms": res["prefill_ms"], "place_ms": res["place_ms"],
        "decode_ms_per_step": summary_ms(decode), "decode_steps": len(decode),
        "decode_samples_ms": decode, "decode_tokens_per_s": res["decode_tokens_per_s"],
        "tokens_per_s": res["tokens_per_s"], "wall_s": res["wall_s"],
        "peak_mem_gb": res["peak_bytes"] / 2**30, "tokens_head": seqs[:, :8].tolist()}
    emit(f"{tag}_serve_{arch.replace('-', '_').replace('.', '_')}", record)
    d = record["decode_ms_per_step"]
    print(f"{tag}3 ({card}): {arch} {n_params} parameters; prefill flash "
          f"{record['prefill_ms']['pallas']['median']:.2f} ms, dense "
          f"{record['prefill_ms']['dense']['median']:.2f} ms; decode {d['median']:.3f} ms a "
          f"step ({d['min']:.3f}-{d['max']:.3f}); {res['decode_tokens_per_s']:.1f} decode "
          f"tokens/s; peak {record['peak_mem_gb']:.2f} GiB", flush=True)
    print(f"{tag}1/{tag}2: flash vs dense {p1:.3e} (control {p1_control:.3e}); decode vs "
          f"forced {p2:.3e} (control {p2_control:.3e}); tolerance {F_LOGIT_TOL}", flush=True)
    check(p1 <= F_LOGIT_TOL, f"{tag}1: flash prefill logits {p1} from dense > {F_LOGIT_TOL}")
    check(p1_control > F_LOGIT_TOL,
          f"{tag}1: the non-causal control is only {p1_control} from dense, inside "
          f"the tolerance {F_LOGIT_TOL}")
    check(p2 <= F_LOGIT_TOL,
          f"{tag}2: decode logits {p2} from the forced forward > {F_LOGIT_TOL}")
    check(p2_control > F_LOGIT_TOL,
          f"{tag}2: decoding at pos + 1 is only {p2_control} from the forced forward, "
          f"inside the tolerance {F_LOGIT_TOL}")
    del params, res, last, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return launches["pallas"]


@contextlib.contextmanager
def expandable_segments():
    """The caching allocator's expandable segments for the enclosed phase,
    the default again after it. P4's second step asks for the 7.85 GiB fp32
    logits of the 257280-column head while 25 GiB lie free in fixed
    segments too small for it (46 GiB allocated): segments that grow in
    place take the request. Only the allocator's layout changes."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._accelerator_setAllocatorSettings("expandable_segments:True")
    try:
        yield
    finally:
        gc.collect()
        torch.cuda.empty_cache()
        torch._C._accelerator_setAllocatorSettings("expandable_segments:False")


def frontend_train(arch, tag, buckets, n_params):
    """<tag>4: ``arch`` at full width and depth trained with single-pass
    RMNP through launch.train.train (B=8, S=1024, bf16, seed 0; the data
    stream's frontend arrays in each batch): 2 timed steps with one apply
    launch a bucket, tokens/s, peak memory; a second run equal bit for bit;
    one more step profiled."""
    with expandable_segments():
        rec, launches, params, _ = ssm_train(arch, "", F_TRAIN_STEPS, F_TRAIN_BATCH,
                                             F_TRAIN_SEQ, len(buckets), tag)
        del params
    check(rec["params"] == n_params, f"{tag}: {rec['params']} parameters, want {n_params}")
    check(sorted(rec["buckets"]) == sorted(f"{a}x{b}" for _, a, b in buckets),
          f"{tag} buckets {rec['buckets']}")
    rec["config"] = f"{arch}, full width and depth"
    emit(f"{tag}_train_{arch.replace('-', '_')}", rec)
    prof = rec["profile"] or {}
    print(f"{tag} ({rec['card']}): steps {[round(s, 3) for s in rec['step_s']]} s, "
          f"{rec['tokens_per_s']:.0f} tokens/s, peak {rec['peak_mem_gb']:.2f} GiB, "
          f"{len(buckets)} apply launches a step; {prof.get('launches')} device ops a "
          f"step, idle {rec['idle_share']}", flush=True)
    return {"rmnp_apply": launches, "step_s": rec["step_s_median"]}


def phase_paligemma():
    """P: paligemma-3b at full width (18 layers, H = 8 on K = 1 at hd 256,
    the tied 257280 x 2048 embedding; 2,508,793,856 parameters). P1-P3
    serve it (the hd-256 flash kernel, 18 launches a prefill) with 256
    image embeddings in front of each 1024-position prompt; P4 trains it."""
    launches = frontend_serve(P_ARCH, "P")
    return launches, frontend_train(P_ARCH, "P4", P_BUCKETS, 2_508_793_856)


def phase_musicgen():
    """G: musicgen-large at full width (48 layers, H = K = 32 at hd 64;
    3,229,812,736 parameters). G1-G3 serve it from 1024 audio frames a
    request (the hd-64 flash kernel, 48 launches a prefill); G4 trains it."""
    launches = frontend_serve(G_ARCH, "G")
    return launches, frontend_train(G_ARCH, "G4", G_BUCKETS, 3_229_812_736)


# Phase Q runs the examples of examples_torch/ through their main(argv). The
# card against the CPU from one CPU init is held as phase D holds its
# reduced runs: each logged loss and grad norm, and the dominance ratios,
# within Q_TOL relative (fp32, TF32 off; 50 steps drift by ~1e-6).
EXAMPLES = ROOT / "examples_torch"
Q_TOL = 1e-4
Q_FACEOFF = ["--full", "--steps", "20", "--only", "adamw", "muon", "rmnp"]


def example_module(name):
    """``examples_torch/<name>.py`` as a module (the directory is no package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"examples_torch_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_example(main, argv):
    """``main(argv)`` with its standard output captured: (result, text)."""
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


def phase_examples():
    """Q: the four examples on the card, as a user runs them, through their
    main(argv). quickstart (reduced gpt2, 50 per-leaf RMNP steps) on the
    card and on the CPU from one CPU init: every logged loss and grad norm
    and the dominance ratios within Q_TOL; serve_batched (reduced qwen3-4b,
    B=4, 16-token prompts, 32 tokens) on both from one CPU init and the
    same prompts: the same tokens; the faceoff at full width (gpt2-small,
    B=16, S=64, 20 steps of adamw, muon and rmnp on the bucketed engine):
    finite losses, each logged step's launches (4 precondition launches a
    rmnp step, 40 matmul3 and 20 ns_poly3 a muon step, none for adamw) and
    the equal-wall summary; the restart's act 1 on the card (stop at step
    40, resume, bit for bit; act 2, on the CPU by design, runs in the CPU
    tests). Each example's output goes to chiprun_out/Q_examples.txt."""
    import torch
    from repro_torch.core.types import tree_map
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import init_params

    def cpu_init(cfg, seed=0, device="cuda"):
        # one CPU init, copied to the device asked for: a torch.Generator on
        # the card draws other numbers than one on the CPU
        return tree_map(lambda t: t.to(device), init_params(cfg, seed=seed, device="cpu"))

    def cpu_prompts(cfg, batch, prompt_len, device):
        gen = torch.Generator().manual_seed(1)
        return torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen).to(device)

    texts, launches, card = {}, {}, card_name()

    def rel(a, b):
        return abs(a - b) / abs(b)

    qs = example_module("quickstart")
    qs.init_params = cpu_init
    runs = {}
    for device in ("cuda", "cpu"):
        reset_launches()
        runs[device], texts[f"quickstart --device {device}"] = run_example(
            qs.main, ["--device", device])
        launches[f"quickstart_{device}"] = dict(LAUNCHES)
    qc, qh = runs["cuda"], runs["cpu"]
    check([s for s, _, _ in qc["logged"]] == [s for s, _, _ in qh["logged"]],
          f"Q quickstart logged steps {qc['logged']} {qh['logged']}")
    q_loss = max(rel(a[1], b[1]) for a, b in zip(qc["logged"], qh["logged"], strict=True))
    q_gnorm = max(rel(a[2], b[2]) for a, b in zip(qc["logged"], qh["logged"], strict=True))
    q_dom = max(rel(qc["dominance"][k], qh["dominance"][k]) for k in qh["dominance"])
    n_pre = launches["quickstart_cuda"]["rmnp_precondition"]
    check(n_pre > 0 and n_pre % qs.STEPS == 0
          and launches["quickstart_cpu"]["rmnp_precondition"] == 0,
          f"Q quickstart: precondition launches {launches}")

    sb = example_module("serve_batched")
    sb.init_params, sb.prompt_tokens = cpu_init, cpu_prompts
    served = {}
    for device in ("cuda", "cpu"):
        served[device], texts[f"serve_batched --device {device}"] = run_example(
            sb.main, ["--device", device])
    tokens_equal = torch.equal(served["cuda"]["tokens"], served["cpu"]["tokens"])

    fo = example_module("train_optimizer_faceoff")
    reset_launches()
    faceoff, texts["train_optimizer_faceoff " + " ".join(Q_FACEOFF)] = run_example(
        fo.main, Q_FACEOFF)
    launches["faceoff"] = dict(LAUNCHES)
    per_step = {"adamw": {}, "rmnp": {"rmnp_precondition": 4},
                "muon": {"matmul3": 40, "ns_poly3": 20}}
    for opt, r in faceoff.items():
        hist = r["history"]
        check(all(math.isfinite(h["loss"]) for h in hist), f"Q faceoff {opt} losses")
        for h in hist:
            got = {k: n for k, n in h["launches"].items() if n}
            check(got == per_step[opt], f"Q faceoff {opt} step {h['step']} launches {got}")

    rs = example_module("fault_tolerant_restart")
    reset_launches()
    restart, texts["fault_tolerant_restart --act 1"] = run_example(rs.main, ["--act", "1"])
    launches["restart_act1"] = dict(LAUNCHES)
    check(launches["restart_act1"]["rmnp_precondition"] > 0,
          f"Q restart: no kernel launched {launches['restart_act1']}")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "Q_examples.txt").write_text("".join(
        f"=== {name} ===\n{text}\n" for name, text in texts.items()))
    record = {
        "card": card, "quickstart_losses_cuda": [x[1] for x in qc["logged"]],
        "quickstart_losses_cpu": [x[1] for x in qh["logged"]],
        "quickstart_loss_rel": q_loss, "quickstart_grad_norm_rel": q_gnorm,
        "quickstart_dominance_cuda": qc["dominance"], "quickstart_dominance_cpu": qh["dominance"],
        "quickstart_dominance_rel": q_dom, "tolerance": Q_TOL,
        "serve_tokens_equal": tokens_equal, "serve_seconds": served["cuda"]["seconds"],
        "serve_device": served["cuda"]["device"],
        "faceoff": {opt: {"final": r["final"], "wall_s": r["wall_s"],
                          "at_budget": r["at_budget"]} for opt, r in faceoff.items()},
        "restart_act1_worst": restart["act1"]["worst"], "launches": launches}
    emit("Q_examples", record)
    print(f"Q ({card}): quickstart card vs CPU: losses {q_loss:.2e}, grad norms "
          f"{q_gnorm:.2e}, dominance {q_dom:.2e} (tolerance {Q_TOL}); serve_batched tokens "
          f"equal: {tokens_equal}; faceoff finals "
          f"{ {o: round(r['final'], 4) for o, r in faceoff.items()} }; restart act 1 worst "
          f"{restart['act1']['worst']}", flush=True)
    check(max(q_loss, q_gnorm, q_dom) <= Q_TOL,
          f"Q quickstart: card against CPU {q_loss}, {q_gnorm}, {q_dom} > {Q_TOL}")
    check(tokens_equal, "Q serve_batched: the card's tokens differ from the CPU's")
    check(restart["act1"]["worst"] == 0.0, "Q restart: act 1 is not exact")
    # every launch on the card in the examples' runs, per kernel
    return {k: sum(d.get(k, 0) for name, d in launches.items() if not name.endswith("cpu"))
            for k in LAUNCHES}


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def host_copy(tree):
    """[(path, CPU tensor)] of a tree of tensors, for bit comparisons."""
    from repro_torch.core.types import tree_paths
    return [(p, t.detach().to("cpu", copy=True)) for p, t in tree_paths(tree)]


def differing(a, b):
    """Paths whose bits differ between two host copies (or the path lists)."""
    import torch
    if [p for p, _ in a] != [p for p, _ in b]:
        return ["<tree structure>"]
    out = []
    for (p, x), (_, y) in zip(a, b, strict=True):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
                y.view(torch.int16) if y.dtype == torch.bfloat16 else y):
            out.append(p)
    return out


def step_seconds(hist):
    walls = [0.0] + [h["wall_s"] for h in hist if "wall_s" in h]
    return [round(b - a, 3) for a, b in zip(walls, walls[1:])]


def phase_resilience():
    """R: checkpointing and the guard on llama-130m at full width."""
    import os
    import shutil
    import warnings
    import torch
    from repro_torch.checkpoint import faults as ckpt_faults
    from repro_torch.checkpoint.manager import CheckpointCorruptionError, CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.core import cosine_with_warmup, make_optimizer
    from repro_torch.data.pipeline import make_stream
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch.train import batch_to_device, train
    from repro_torch.models import init_params
    from repro_torch.train.step import make_train_step

    work = ROOT / "build" / "phase_r"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    kw = dict(reduced=False, optimizer="rmnp", fused=True, fused_apply=True, use_kernel=True,
              batch=R_BATCH, seq=R_SEQ, steps=R_STEPS, log_every=1, seed=0)
    n_buckets = len(LLAMA_BUCKETS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # R1: two uninterrupted runs from one init (the seed, on the card)
    reset_launches()
    p, s, h1 = train(R_ARCH, **kw)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    ref = host_copy((p, s))
    n_params = sum(t.numel() for _, t in host_copy(p))
    buckets = {k: list(b.shape) for k, b in s.buckets.items()}
    del p, s
    p, s, h2 = train(R_ARCH, **kw)
    diff = differing(ref, host_copy((p, s)))
    losses = [h["loss"] for h in h1]
    emit("R1_determinism", {
        "model": R_ARCH, "batch": R_BATCH, "seq": R_SEQ, "steps": R_STEPS,
        "params": n_params, "buckets": buckets, "losses": losses,
        "losses_second_run": [h["loss"] for h in h2], "step_s": step_seconds(h1),
        "step_s_second_run": step_seconds(h2), "launches": launches,
        "bitwise_equal": not diff, "differing_leaves": diff[:20],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    check(sorted(buckets) == sorted(f"{a}x{b}" for _, a, b in LLAMA_BUCKETS),
          f"llama buckets {buckets}")
    check(all(math.isfinite(x) for x in losses), f"llama losses {losses}")
    check([h["launches"]["rmnp_apply"] for h in h1] == [n_buckets] * R_STEPS,
          f"apply launches per step {[h['launches'] for h in h1]}")
    check(not diff, f"two runs from one init differ in {len(diff)} leaves: {diff[:5]}")
    del p, s
    torch.cuda.empty_cache()

    # R2: stop at step 3 and restart; SIGKILL with an async save in flight
    stop_dir = work / "stop"
    p, s, _ = train(R_ARCH, stop_at=3, ckpt_dir=str(stop_dir), ckpt_every=3, **kw)
    at3 = host_copy((p, s))
    del p, s
    p, s, hr = train(R_ARCH, ckpt_dir=str(stop_dir), ckpt_every=3, **kw)
    diff_stop = differing(ref, host_copy((p, s)))
    del p, s
    kill_dir = work / "kill"
    code = ("import sys; sys.path.insert(0, 'src'); "
            "from repro_torch.launch.train import train; "
            f"train({R_ARCH!r}, reduced=False, optimizer='rmnp', fused=True, fused_apply=True, "
            f"batch={R_BATCH}, seq={R_SEQ}, steps={R_STEPS}, log_every=1, seed=0, "
            "ckpt_every=2, kill_at=4, ckpt_dir=sys.argv[1])")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", code, str(kill_dir)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    kill_s = time.time() - t0
    committed = sorted(int(d.name.split("_")[1]) for d in kill_dir.glob("step_*")
                       if (d / "COMMITTED").exists())
    torn = sorted(d.name for d in kill_dir.glob(".tmp_step_*"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p, s, hk = train(R_ARCH, ckpt_dir=str(kill_dir), ckpt_every=2, **kw)
    diff_kill = differing(ref, host_copy((p, s)))
    left = sorted(d.name for d in kill_dir.glob(".tmp_step_*"))
    emit("R2_crash_resume", {
        "stop_at": 3, "resumed_steps": [h["step"] for h in hr], "stop_bitwise_equal":
        not diff_stop, "stop_differing": diff_stop[:20], "kill_returncode": proc.returncode,
        "kill_s": round(kill_s, 2), "committed_at_kill": committed, "torn_at_kill": torn,
        "resumed_after_kill_from": hk[0]["step"] if hk else None,
        "tmp_left_after_restart": left, "kill_bitwise_equal": not diff_kill,
        "kill_differing": diff_kill[:20],
        "restart_warnings": [str(w.message)[:200] for w in caught]})
    check(not diff_stop, f"stop/resume differs from the uninterrupted run in {diff_stop[:5]}")
    check(proc.returncode == -9, f"kill_at: return code {proc.returncode}, "
                                 f"stderr {proc.stderr[-2000:]}")
    check("SIGKILL at step 4" in proc.stdout, "kill_at: the process did not reach step 4")
    check(4 not in committed and committed and committed[-1] == 2,
          f"kill_at: committed steps {committed}; the step-4 save should be in flight")
    check(hk and hk[0]["step"] == committed[-1], f"kill restart resumed at {hk[:1]}")
    check(not left, f"kill restart left {left}")
    check(not diff_kill, f"kill/resume differs from the uninterrupted run in {diff_kill[:5]}")
    shutil.rmtree(kill_dir)

    # R3: the guard skips a NaN step bit for bit; a sticky fault rewinds
    pg, sg, hg = train(R_ARCH, guard=True, inject_fault="nan:*:2", **kw)
    guarded = host_copy((pg, sg))
    del pg, sg
    cfg = get_config(R_ARCH)
    opt = make_optimizer("rmnp", dict(
        lr_matrix=cosine_with_warmup(2e-3, R_STEPS), lr_adamw=cosine_with_warmup(1e-3, R_STEPS),
        fused=True, fused_apply=True))
    params = init_params(cfg, seed=0, device="cuda")
    state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat="full")
    stream = make_stream(cfg, R_SEQ, R_BATCH, seed=0)
    for t in range(R_STEPS):
        batch = batch_to_device(next(stream), "cuda")
        if t != 2:
            params, state, _ = step_fn(params, state, batch, t)
    diff_guard = differing(host_copy((params, state)), guarded)
    del params, state
    rewind_dir = work / "rewind"
    _, _, hw = train(R_ARCH, guard=True, inject_fault="nan:*:4+", ckpt_dir=str(rewind_dir),
                     ckpt_every=2, anomaly_skip_budget=1, anomaly_health_window=1, **kw)
    rewinds = [h for h in hw if h.get("action") == "rewind"]
    skipped = [h["skipped"] for h in hg]
    emit("R3_guard", {
        "skipped": skipped, "actions": [h.get("action") for h in hg],
        "nonfinite_at_step_2": hg[2].get("nonfinite"), "losses": [h["loss"] for h in hg],
        "bitwise_equal_to_clean_run_without_step_2": not diff_guard,
        "differing": diff_guard[:20],
        "rewind_run": [(h["step"], h.get("action"), h.get("rewind_to")) for h in hw]})
    check(skipped == [0.0, 0.0, 1.0, 0.0, 0.0, 0.0], f"guard skipped {skipped}")
    check(hg[2].get("nonfinite") == ["embed/tokens"],
          f"step 2's flags name {hg[2].get('nonfinite')}, want the first leaf embed/tokens")
    check(not diff_guard, f"guarded run differs from the clean run in {diff_guard[:5]}")
    check(len(rewinds) == 1 and rewinds[0]["rewind_to"] == 2 and rewinds[0]["step"] == 5,
          f"rewind run {[(h['step'], h.get('action')) for h in hw]}")
    check([h["step"] for h in hw if h.get("action") == "ok"][-4:] == [2, 3, 4, 5],
          "the rewind did not replay steps 2-5")
    shutil.rmtree(rewind_dir)

    # R4: storage faults on a checkpoint written here (stop_dir: steps 3, 6)
    like = (init_params(cfg, seed=0, device="cuda"), None)
    like = (like[0], opt.init(like[0]))
    faults_seen = {}
    for kind in ("bit_rot", "truncated", "missing_shard", "torn_manifest"):
        d = work / f"r4_{kind}"
        for step in (3, 6):
            src = stop_dir / f"step_{step:09d}"
            dst = d / src.name
            dst.mkdir(parents=True)
            for f in src.iterdir():
                written = (f.name == "manifest.json" or (
                    f.suffix == ".npz" and kind in ("bit_rot", "truncated") and step == 6))
                (shutil.copy2 if written else os.link)(f, dst / f.name)
        ckpt_faults.CORRUPTIONS[kind](d / "step_000000006")
        mgr = CheckpointManager(str(d))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                mgr.restore(6, like)
            except CheckpointCorruptionError as e:
                error = str(e)
            else:
                error = None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = mgr.restore_latest(like)
        back = got[1] if got else None
        diff4 = differing(at3, host_copy(got[0])) if got else ["<nothing restored>"]
        faults_seen[kind] = {"error": error, "fell_back_to": back, "bitwise_equal": not diff4,
                             "warning": [str(w.message)[:240] for w in caught]}
        del got
        shutil.rmtree(d)
    emit("R4_corruption", faults_seen)
    for kind, rec in faults_seen.items():
        check(rec["error"] is not None and ("leaf '" in rec["error"] or "shard" in rec["error"]
                                            or "manifest.json" in rec["error"]),
              f"{kind}: not detected by name: {rec['error']}")
        check(rec["fell_back_to"] == 3 and rec["bitwise_equal"],
              f"{kind}: restore_latest gave step {rec['fell_back_to']}, "
              f"equal {rec['bitwise_equal']}")

    # R5: cost, reported and not gated; medians of 5 interleaved samples
    params, state = like
    del like
    batch = batch_to_device(make_stream(cfg, R_SEQ, R_BATCH, seed=0).sample(0), "cuda")
    plain = make_train_step(cfg, opt, remat="full")
    guarded_fn = make_train_step(cfg, opt, remat="full", guard=True)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t, out

    amgr = CheckpointManager(str(work / "r5_async"), keep=1)
    bmgr = CheckpointManager(str(work / "r5_block"), keep=1, async_save=False)
    stall = {"async": [], "blocking": [], "async_write": []}
    step_t = {"plain": [], "write_in_flight": [], "guarded": []}
    for i in range(7):  # two rounds fill both host buffers and are dropped
        torch.cuda.synchronize()
        t = time.perf_counter()
        amgr.save(i, (params, state))
        a = time.perf_counter() - t
        dt_flight, _ = timed(lambda: plain(params, state, batch, 3))
        t = time.perf_counter()
        amgr.wait()
        w = time.perf_counter() - t + a + dt_flight
        dt_plain, _ = timed(lambda: plain(params, state, batch, 3))
        dt_guard, _ = timed(lambda: guarded_fn(params, state, batch, 3))
        t = time.perf_counter()
        bmgr.save(i, (params, state), block=True)
        b = time.perf_counter() - t
        if i >= 2:
            stall["async"].append(a)
            stall["blocking"].append(b)
            stall["async_write"].append(w)
            step_t["write_in_flight"].append(dt_flight)
            step_t["plain"].append(dt_plain)
            step_t["guarded"].append(dt_guard)
    (step_dir,) = (work / "r5_block").glob("step_*")
    nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
    med = {k: statistics.median(v) * 1e3 for k, v in {**stall, **step_t}.items()}
    card = card_name()
    emit("R5_cost", {
        "card": card, "save_stall_ms_async": med["async"], "save_stall_ms_blocking":
        med["blocking"], "async_save_to_commit_ms": med["async_write"],
        "step_ms_plain": med["plain"], "step_ms_write_in_flight": med["write_in_flight"],
        "step_ms_guarded": med["guarded"], "checkpoint_bytes": nbytes,
        "samples_ms": {k: [round(x * 1e3, 3) for x in v] for k, v in {**stall, **step_t}.items()}})
    print(f"R5 ({card}): save() stall async {med['async']:.2f} ms, blocking "
          f"{med['blocking']:.1f} ms; step {med['plain']:.1f} ms, with a write in flight "
          f"{med['write_in_flight']:.1f} ms, guarded {med['guarded']:.1f} ms; "
          f"{nbytes / 2**30:.3f} GiB a checkpoint", flush=True)
    del params, state, batch
    shutil.rmtree(work)
    torch.cuda.empty_cache()
    return {"rmnp_apply": launches["rmnp_apply"]}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t0 = time.time()
    run_phase("build", phase_build)
    v_pool, v_pending = start_dryrun()
    rmnp = run_phase("A", phase_rmnp)
    attn_cases = run_phase("B", phase_attention)
    attn, attn_fp32 = attn_cases["main"], attn_cases["main_fp32"]
    ns = run_phase("E", phase_ns)
    census = run_phase("K", phase_census)
    launches = run_phase("C1-C3", phase_train)
    fp32_launches = run_phase("C3f", phase_train_fp32)
    t_launches = run_phase("T1-T2", phase_train_fp32_wide)
    launches.update(run_phase("C4", phase_muon))
    d_launches = run_phase("D", phase_small)
    serve_launches = run_phase("S", phase_serve, S_ARCH, "S")
    h_launches = run_phase("H", phase_serve, H_ARCH, "H")
    n_launches = run_phase("N", phase_serve, N_ARCH, "N")
    y_launches = run_phase("Y", phase_serve, Y_ARCH, "Y")
    m2_launches = run_phase("M2", phase_mla_serve)
    m1 = run_phase("M1", phase_mla_train)
    run_phase("V", phase_dryrun, v_pending)
    v_pool.shutdown()
    o_launches = run_phase("O", phase_olmoe_serve)
    o2 = run_phase("O2", phase_olmoe_train)
    y2 = run_phase("Y2", phase_yi_train)
    x1 = run_phase("X1", phase_xlstm_train)
    run_phase("X2", phase_xlstm_serve)
    j1_launches = run_phase("J1", phase_jamba_serve)
    j2 = run_phase("J2", phase_jamba_train)
    p_launches, p4 = run_phase("P", phase_paligemma)
    g_launches, g4 = run_phase("G", phase_musicgen)
    q_launches = run_phase("Q", phase_examples)
    llama_launches = run_phase("R", phase_resilience)
    zero_launches = run_phase("Z", phase_zero)

    smi = card_name()
    print(smi, flush=True)
    src = "src/repro_torch/csrc/rmnp_update.cu"
    kernels = [
        {"name": "rmnp_apply", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/rmnp_update.py:129",
         "launches": launches["rmnp_apply"], **rmnp["rmnp_apply"], "bound_by": "bytes",
         "library_ms": None, "launches_llama_130m_R1": llama_launches["rmnp_apply"],
         "launches_Z1": zero_launches["rmnp_apply"],
         # deepseek-v2-lite-16b cut to 3 layers: its 13 buckets summed (phase
         # A, fp32 g and v, bf16 w) and the apply launches of M1's 3 steps
         "deepseek_3_layers": rmnp["rmnp_apply"]["deepseek"],
         "launches_M1": m1["rmnp_apply"],
         "M1_optimizer_share": rmnp["rmnp_apply"]["deepseek"]["ms"] / 1e3 / m1["step_s"],
         # xlstm-350m cut to 12 layers (7 buckets) and jamba cut to layers
         # 3-4 (10 buckets): phase A's sums and the apply launches of X1's
         # and J2's first runs
         "xlstm_350m": rmnp["rmnp_apply"]["xlstm"], "launches_X1": x1["rmnp_apply"],
         "X1_optimizer_share": rmnp["rmnp_apply"]["xlstm"]["ms"] / 1e3 / x1["step_s"],
         "jamba_2_layers": rmnp["rmnp_apply"]["jamba"], "launches_J2": j2["rmnp_apply"],
         "J2_optimizer_share": rmnp["rmnp_apply"]["jamba"]["ms"] / 1e3 / j2["step_s"],
         # paligemma-3b's tied embedding bucket 1x257280x2048 (phase A, fp32
         # g and v, bf16 w) and the apply launches of P4's and G4's first
         # runs (5 and 3 buckets a step)
         "paligemma_embedding": rmnp["rmnp_apply"]["paligemma"],
         "launches_P4": p4["rmnp_apply"], "launches_G4": g4["rmnp_apply"],
         # yi-9b and olmoe-1b-7b cut to layers 0:2: their 6 and 5 buckets
         # summed (phase A) and the apply launches of Y2's and O2's 3 steps
         "yi_9b_2_layers": rmnp["rmnp_apply"]["yi"], "launches_Y2": y2["rmnp_apply"],
         "Y2_optimizer_share": rmnp["rmnp_apply"]["yi"]["ms"] / 1e3 / y2["step_s"],
         "olmoe_2_layers": rmnp["rmnp_apply"]["olmoe"], "launches_O2": o2["rmnp_apply"],
         "O2_optimizer_share": rmnp["rmnp_apply"]["olmoe"]["ms"] / 1e3 / o2["step_s"]},
        {"name": "rmnp_precondition", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/rmnp_update.py:63",
         "launches": launches["rmnp_precondition"], **rmnp["rmnp_precondition"],
         "bound_by": "bytes", "library_ms": None},
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_fwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:37",
         "launches": launches["flash_attention_fwd"], "max_abs_err": attn["max_abs_err"],
         "worst_ratio": attn["worst_ratio"], "ms": attn["kernel_ms"], "plain_ms": attn["plain_ms"],
         "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
         "library_ms": attn["library_ms"],
         # hd 128 at qwen3-4b's prefill shape (B=8, S=1024, H=32, K=8,
         # causal), 36 launches a served prefill in phase S
         "hd128": {k: attn_cases["qwen3_hd128"][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "bound_three_part_ms", "flops", "flops_three_part", "max_abs_err",
             "worst_ratio")},
         "launches_S": serve_launches,
         # hd 128 at yi-9b's prefill shape (H=32 on K=4, G = 8), 48 launches a
         # served prefill in Y, and at olmoe-1b-7b's (H=K=16, G = 1), 16 in O
         **{key: {k: attn_cases[case][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "bound_three_part_ms", "flops", "flops_three_part", "max_abs_err",
             "worst_ratio")} for key, case in (("hd128_yi", "yi_hd128"),
                                               ("hd128_olmoe", "olmoe_hd128"))},
         "launches_Y": y_launches, "launches_O": o_launches,
         # MLA's (192, 128) at deepseek-v2-lite's prefill shape (B=8, S=1024,
         # H=K=16, causal, v a strided view), 27 launches a served prefill in M2
         "hd192_hdv128": {**{k: attn_cases["deepseek_mla"][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "bound_three_part_ms", "flops", "flops_three_part", "max_abs_err",
             "worst_ratio")},
             "ptxas": RESULTS["B_attention"]["ptxas"]["fa_fwd_tc"].get("hd192_128"),
             "hgmma": RESULTS["B_attention"]["hgmma"]["fa_fwd_tc"].get("fa_fwd_tc_192_128")},
         "launches_M2": m2_launches,
         # hd 256 at paligemma-3b's prefill shape (B=8, S=1024, H=8, K=1,
         # causal), 18 launches a served prefill in P; musicgen-large's 48
         # layers at hd 64 in G
         "hd256": {**{k: attn_cases["paligemma_hd256"][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "bound_three_part_ms", "flops", "flops_three_part", "max_abs_err",
             "worst_ratio")},
             "ragged": {k: attn_cases["ragged_hd256"][k] for k in (
                 "kernel_ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err",
                 "worst_ratio")},
             "ptxas": RESULTS["B_attention"]["ptxas"]["fa_fwd_tc"].get("hd256_256"),
             "hgmma": RESULTS["B_attention"]["hgmma"]["fa_fwd_tc"].get("fa_fwd_tc_256_256")},
         "launches_P": p_launches, "launches_G": g_launches,
         # hd 96: phi3-mini-3.8b's (96, 96) at its prefill shape (B=8,
         # S=1024, H=K=32, causal), 32 launches a served prefill in H, and
         # minicpm3-4b's MLA (96, 64) (H=K=40, v a strided view), 62 in N
         **{key: {**{k: attn_cases[case][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
             "bound_three_part_ms", "flops", "flops_three_part", "max_abs_err",
             "worst_ratio")},
             "ptxas": RESULTS["B_attention"]["ptxas"]["fa_fwd_tc"].get(f"hd{pair}"),
             "hgmma": RESULTS["B_attention"]["hgmma"]["fa_fwd_tc"].get(f"fa_fwd_tc_{pair}")}
            for key, case, pair in (("hd96", "phi3_hd96", "96_96"),
                                    ("hd96_hdv64", "minicpm3_mla", "96_64"))},
         "launches_H": h_launches, "launches_N": n_launches,
         # every bf16 build's registers, spill bytes and setmaxnreg/HGMMA
         # instructions (phase B: no spill, USETMAXREG beside HGMMA)
         "bf16_builds": RESULTS["B_attention"]["bf16_design"],
         # jamba's first group of 8 layers: its one GQA layer (H=32, K=8, hd
         # 128, qwen3-4b's case) a served prefill in J1
         "launches_J1": j1_launches,
         # the fp32 kernel (csrc/flash_attention_fwd_tf32.cu): launches on
         # C3f, and per timed shape its time, plain and SDPA times and its
         # 3xTF32 bound
         "fp32_source": "src/repro_torch/csrc/flash_attention_fwd_tf32.cu",
         "launches_C3f": fp32_launches,
         "fp32": {name: {k: attn_cases[name][k] for k in (
             "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "max_abs_err",
             "worst_ratio")} for name in ("main_fp32", "gqa_ragged_fp32")}},
        # the same TPU kernel in fp32, its own source: launches on C3f, times
        # at the full-width shape C3f runs
        {"name": "flash_attention_fwd_fp32", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_fwd_tf32.cu",
         "replaces": "src/repro/kernels/flash_attention.py:37", "launches": fp32_launches,
         "max_abs_err": attn_fp32["max_abs_err"], "worst_ratio": attn_fp32["worst_ratio"],
         "ms": attn_fp32["kernel_ms"], "plain_ms": attn_fp32["plain_ms"],
         "bound_ms": attn_fp32["bound_ms"], "bound_by": attn_fp32["bound_by"],
         "library_ms": attn_fp32["library_ms"]},
    ]
    # the fp32 kernel's wide builds, one entry each: its model's prefill
    # shape (phase B), launches on the main path's run that takes it (T1,
    # T2, or phase D's card run of a reduced model at the full head dims),
    # registers and spills
    fp32_runs = {(128, 128): ("T1", t_launches["T1"]), (192, 128): ("T2", t_launches["T2"]),
                 **{(hd, hdv): (f"D {tag}", d_launches[tag]) for tag, hd, hdv in (
                     ("phi3-mini-3.8b_hd96_96", 96, 96), ("minicpm3-4b_hd96_64", 96, 64),
                     ("paligemma-3b_hd256_256", 256, 256))}}
    for tag, _, _, hd, hdv in FP32_WIDE:
        case, (run, n) = attn_cases[f"{tag}_fp32"], fp32_runs[(hd, hdv)]
        kernels.append({
            "name": f"flash_attention_fwd_fp32_hd{hd}_{hdv}", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_fwd_tf32.cu",
            "replaces": "src/repro/kernels/flash_attention.py:37", "launches": n,
            "launches_in": run, **{k: case[k] for k in (
                "max_abs_err", "worst_ratio", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "bound_ffma_ms", "B", "S", "H", "K", "causal")},
            "ms": case["kernel_ms"],
            "build": RESULTS["B_attention"]["fp32_design"][f"hd{hd}_{hdv}"]})
    replaces = {"matmul": "src/repro/kernels/matmul.py:19",
                "matmul3": "src/repro/kernels/matmul.py:69",
                "ns_poly": "src/repro/kernels/newton_schulz.py:26",
                "ns_poly3": "src/repro/kernels/newton_schulz.py:49"}
    for name, where in replaces.items():
        kernels.append({"name": name, "route": "cuda", "source": "src/repro_torch/csrc/matmul.cu",
                        "replaces": where, "launches": launches[name], **ns[name]})
        if name in zero_launches:
            kernels[-1]["launches_Z3"] = zero_launches[name]
    # phase K's census: the launches of each kernel in the run that took it
    census_runs = {"rmnp_apply": "rmnp_single_pass", "rmnp_precondition": "rmnp_two_pass",
                   "flash_attention_fwd": "forward_flash", "matmul3": "muon_bucketed",
                   "ns_poly3": "muon_bucketed"}
    for entry in kernels:
        if entry["name"] in census_runs:
            entry["launches_K"] = census[census_runs[entry["name"]]][entry["name"]]
        # the examples' runs on the card (phase Q)
        if q_launches.get(entry["name"]):
            entry["launches_Q"] = q_launches[entry["name"]]
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": smi, "seconds": time.time() - t0, "phase_seconds": PHASE_SECONDS,
         "kernels": kernels, "phases": RESULTS}, indent=1))
    print(json.dumps({"phase_seconds": PHASE_SECONDS, "seconds": time.time() - t0}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
