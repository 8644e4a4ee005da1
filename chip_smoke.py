#!/usr/bin/env python3
"""Smoke run of da4ml_tpu_torch on one NVIDIA GPU.

Drives the port's main paths end to end on the card and checks every kernel
on them against its plain PyTorch version:

1. card: prints ``nvidia-smi``'s name and power limit and the host's CPU
   model; nvcc builds the DAIS kernel K1 (``csrc/dais_exec.cu``), the
   greedy-CSE kernel K2 (``csrc/fused_cse.cu``) and K2's phase-timing build,
   sm_90a, one nvcc each, and g++ the native host library
   (``native/src``), all started together; prints ptxas' report of K1 and K2,
   ``g++ --version`` and the native library's path and build seconds, and
   loads it (a failed build fails the script with the compiler's output);
2. host solves: traces the flagship MLP (16→32→32→5, 4-bit weights) through
   the port's tracer into one DAIS program with each host solver, timed on
   its own: ``'cpu'`` (the Python solver, a spawned worker pool while the
   native library is loaded in this process), ``'cpp'`` (the native one)
   and ``'auto'`` (which must resolve to the native one); the three programs
   must be byte-identical;
3. K1 corpus: the DAIS kernel against its plain ``level`` version on the
   card, bit for bit (``torch.equal``), on a seeded synth corpus that covers
   all eleven opcode families and wide int64 programs, at batches of 33,
   1000 and 131073 rows; one program's block takes more than 48 KB of shared
   memory, one runs two tiles a block, and one int64 program takes the
   global-memory scratch path; two programs take the 24-bit-field layout
   (65537 inputs, and over 65535 slots on the global-memory path; batches
   of 33 and 1000); prints each program's slots, phases, tiles per block,
   warps per tile, record layout and bytes, the occupancy API's resident
   warps per SM, buffer path, and ptxas' registers and spills of the
   instantiation it runs;
4. device search (K2's main path): ``flagship_comb(backend='torch')`` traces
   and solves the flagship with the device CMVM search on the card (K2's
   launch count is reset just before and read just after; every rung call is
   recorded; the wall time has no stage timer inside); no lane may go to the
   host, ``torch_search.init_cache`` must not run (K2 builds the score cache
   itself), the host side must go through the native library (its
   ``decompose_batch`` and ``emit_batch`` calls counted), and the program
   must be byte-identical to the host-solved one; a second run of the same
   search, emission in series, times the rung calls by stage (the resident
   ladder's transition, upload, K2, fetch) and the host
   side by stage (tracing, decomposition, emission), and a third does the
   same with the Python host side (``has_emit`` patched off);
5. flagship execution (K1's main path): 2^20 numpy-seeded samples through
   ``DaisExecutor`` on the device-solved program (K1's count reset just
   before, read just after) and through ``entry()``; the output must equal
   the plain version on the card and the reference interpreter on the host;
   prints its launch shape as for the corpus (at least 24 resident warps per
   SM); the call goes through the call boundary (the float64 batch up, the
   conversion and the int->float on the card; one chunk here): its output
   and ``BOUNDARY_REPEATS`` more calls must equal the one-launch route
   (host conversion, one launch, ``.cpu()``), and so must
   ``BOUNDARY_REPEATS`` calls at the reference's chunk rule (16 chunks up
   through pinned staging on an upload stream, downloads on another stream);
   prints both calls' times, the call by stage (upload, conversion, K1,
   int->float, download) and the host conversion's four parts (finite
   check, scale, floor, cast) apart;
   times the one-launch route's host stages, and K1 and its plain version; times K1
   again with other phase sizes (one phase per level among them) and warps
   per tile, each held to the plain version; then the host runtimes on the
   same inputs, ``run_comb(backend='cpp')`` on all 2^20 samples and
   ``'numpy'`` on the first 2^16, each bit-equal to K1's output (host
   seconds);
6. K2 corpus: every recorded flagship rung, and seeded random trit lanes
   (i == j chains, methods 0-5, adder/carry sizes unset and set, a padding
   lane, K = 16 classes at P = 512, 1024 and 2048, the last too large for
   shared memory, so its slices take the global placement), through K2 and
   through its plain version on the card, both from the same cache-less
   inputs: all five outputs equal (``torch.equal``); prints each class's
   cluster geometry, occupancy and ptxas report; times K2 and the plain
   version per rung with CUDA events, K2's phases (clock cycles of its
   phase-timing build) on every flagship rung, and the fixed cost of a
   launch whose lanes all enter at ``cur == P`` (on the card, and the host
   time of its foreign call), and counts K2's
   bound from the iterations each rung recorded (the kernel line sums the
   flagship's rungs);
7. wider layers: the four six-bit layers of ``bench.py`` (16×64, 64×32,
   32×32, 32×5), each solved by the native solver (``solve_native``, timed
   per layer) and all by ``solve_torch_many`` on the card; each device
   solution must equal the native one op for op, and ``Pipeline.kernel ==
   kernel``;
8. OpenMP: the native library's OpenMP calls beside CUDA torch's own
   OpenMP runtime. The flagship's ``run_binary`` on 2^18 samples, a replay
   of the device search's ``emit_batch`` calls and the wider layers'
   ``solve_native`` are timed in this process (CUDA torch loaded, the card
   in use) and in two child processes that load the library without torch,
   one at the default thread count and one with ``OMP_NUM_THREADS=1``; a
   child prints the library's ``omp_get_max_threads()`` and each process
   the OpenMP runtimes it maps; all outputs must agree;
9. config-5 model (``bench.py``'s MLP+conv model at full size, rebuilt from
   the port's tracer): traced with ``'cpp'`` and with ``'torch'`` on the
   card (K2's count reset just before, read just after; no lane to the
   host, no ``init_cache`` call), each byte-identical to the JAX package's
   trace with the same solver (the reference's device search and native
   solver give different programs of the same function here); every rung
   call of the 'torch' trace through K2 and through its plain version on
   the card, equal as in 6; 2^20 samples through ``DaisExecutor`` (K1),
   equal to the plain version on the card and, the first 2^16, to the
   reference interpreter; a second call timed against the one-launch route
   (host clock); prints trace and solve seconds, K2's launches and ms, K1's
   ms and launch shape;
10. fusion workloads (``bench.py``'s separable conv stack and relu-attention
   transformer block at full size): solved with ``'torch'`` on the card (no
   lane to the host, no ``init_cache`` call) and with ``'cpp'``, and cut by
   ``to_pipeline``; the two pipelines' stages must be byte-identical and
   equal to the JAX package's (``FUSION_DIGESTS``), and every rung call
   through K2 must equal its plain version on the card, as in 6; 2^16
   samples through ``Pipeline.predict``, one K1 launch a stage and chunk,
   equal to the stage-by-stage reference interpreter and each stage to its
   plain version; then through ``Pipeline.predict(backend='torch')`` with
   ``fused=True``, ``False`` and ``'ir'`` and the per-stage host loop, each
   equal to ``predict(backend='numpy')`` (samples/s and K1 launches of each);
   the fused program (``fuse_binaries``) equal to the JAX package's
   (``FUSED_DIGESTS``), its ``FusionReport``, its launch shape, K1 against its
   plain version and ``FUSED_REPEATS`` launches on the same inputs, none
   differing; prints stages, ops and K1 ms a stage, K2's launches and ms;
11. wide traced program: a 256×256×1 conv front end (65536 inputs, stride
   2, 'valid', relu, ``'cpp'``) through K1's 24-bit-field route on 2048
   samples, equal to the plain version and the reference interpreter; a
   second call timed against the one-launch route (host clock);
12. the conversion on the card at the edges: a batch holding values beyond
   the integer type's range (``OUT_OF_RANGE``) through the conversion of the
   flagship (int32) and of a wide synth program (int64), word for word equal
   to the host's ``_int_inputs``, the whole call equal to the one-launch
   route; a NaN, an inf and a -inf refused with the host's error text;
13. ``bench.py``'s pipeline model (16 -> 64 -> 8, cut at latency 3,
   ``PIPELINE_SAMPLES`` samples) through the same four modes, each equal to
   ``predict(backend='numpy')``, each stage's K1 and the fused program's
   equal to their plain versions on the card;
14. the firmware path: the flagship program written by ``VerilogModel`` and
   ``VHDLModel`` at latency ``FIRMWARE_CUTOFF``, each project equal to the
   JAX package's (``PROJECT_DIGESTS``), ``predict(backend='interp')`` on
   ``FIRMWARE_SAMPLES`` samples through K1, equal to the stage-by-stage
   reference interpreter, and ``predict(backend='netlist')`` of both
   projects equal to K1's rows; the config-5 twin (``models.config5_twin``,
   an ``nn.Module``) through ``trace_model`` with ``'cpp'`` and with
   ``'torch'`` on the card (K2, every rung call equal to its plain version,
   no host lane), each program equal to the JAX package's with the same
   solver (``TWIN_DIGESTS``), ``predict`` on ``FIRMWARE_SAMPLES`` samples of
   its input grid through K1, equal to its plain version and the native
   interpreter, and on the first ``TWIN_FORWARD_SAMPLES`` to the reference
   interpreter and the module's float64 forward,
   its Verilog project equal to the JAX package's and its netlist equal to
   K1's rows; a corrupted program refused by the codegen precondition and
   written with ``DA4ML_VERIFY=0``; prints trace, write, netlist and K1
   times, K1's and K2's bounds, and the wall time of each step;
15. the quality search (``quality=``, the device beam): the flagship traced
   with ``'torch'`` on the card at ``'fast'``, ``'search'`` and ``'max'``
   (K2's count reset just before, read just after; every rung call
   recorded; the beam's fork step, prune and host replay timed), each
   program equal to the JAX package's (``QUALITY_DIGESTS``), run through K1
   on ``QUALITY_SAMPLES`` samples and held to the reference interpreter on
   ``QUALITY_REF_SAMPLES``; ``ci/quality_corpus.npz`` at ``'search'``
   against ``ci/quality_gate.py``'s invariants (never worse than the host
   oracle, a strict win, never worse than ``'fast'``), its costs equal to
   the JAX package's, the device beam equal to the host beam fork for fork,
   and the wall multiplier over ``'fast'``; config 5 at ``'search'``: never
   worse than ``'fast'``, equal to the JAX package's trace, K1 on 2^20
   samples equal to its plain version; every fork rung call (full-capacity
   records) of the flagship and the corpus, and ``CONFIG5_FORK_CHECKS`` of
   config 5's, through K2 and its plain version, equal word for word, their
   K2 ms printed beside the base rung calls'; ``convert --quality search
   --solver-backend torch`` of the config-5 twin in a child process, its
   Verilog project equal to the JAX package's, and with the default
   ``'auto'`` backend, which exits 0 with the degrade warning;
16. telemetry: ``convert --trace`` of the flagship twin's ``.pt``
   (``models.flagship_twin``: the flagship's widths as an ``nn.Module``, so
   the conversion solves through K2) in a child, the trace passed by the
   port's ``validate_trace`` and holding ``cmvm.solve``, ``run.call`` and
   ``codegen.rtl.write``, then ``stats`` and ``trace-view`` on it; the
   device profile in another child started with ``DA4ML_PROFILE`` and
   ``DA4ML_TRACE`` set (``profile_child``: two device solves of the
   flagship, K2, each program equal to the JAX package's, and two flagship
   calls on ``FLAGSHIP_SAMPLES`` samples, K1, held to the reference
   interpreter), every K1 and K2 kernel event of its ``torch.profiler`` trace inside
   its ``da4ml:run.call`` / ``da4ml:cmvm.rung`` range, and the busy shares
   (K2's on the resident ladder, the default)
   (kernel time over the enclosing span's wall time); the flagship call
   timed with telemetry off, ``enable()`` and ``enable(path)``, held to the
   reference interpreter; the live endpoint (``telemetry.serve()`` on an
   ephemeral port) scraped after a flagship call held to the reference
   interpreter, and its ``/metrics`` held to ``validate_openmetrics``. It runs beside the twin's
   g++ build, before phase 17;
17. the executor's forced modes (``DaisExecutor(prog, force_i64, mode)``):
   the flagship at ``FLAGSHIP_SAMPLES`` samples in ``unroll``, ``scan``,
   ``level`` and ``pallas`` (K1), the forced K1 call's first
   ``MODES_REF_SAMPLES`` rows equal to the reference interpreter and every
   other mode's output, none of which launches K1, equal to it on every row,
   each mode's ``fn_int`` timed with CUDA events; the ``MODES_CORPUS`` synth
   programs (narrow and wide) in every mode, as built and with
   ``force_i64=True`` (K1's int64 instantiation for the narrow ones), each
   equal to the reference interpreter; config 5 at
   ``MODES_CONFIG5_SAMPLES`` in ``unroll``, ``scan`` and ``pallas``, equal to
   each other and on the first ``MODES_CONFIG5_REF_SAMPLES`` to the
   reference interpreter, timed; the int64 config-5 twin (under
   ``UNROLL_LIMIT`` ops) at ``MODES_TWIN_SAMPLES`` in ``unroll`` and
   ``pallas``, equal to each other and on the first
   ``MODES_TWIN_REF_SAMPLES`` to the reference interpreter; ``mode='unroll'``
   refusing the 256x256 conv front end (over ``UNROLL_LIMIT`` ops) with the
   reference's message. It runs beside the twin's g++ build, after phase 16;
18. ``mode='auto'`` on the card, with ``DA4ML_RUN_MODE`` unset: the
   flagship, config 5 (``'torch'``), the transformer block's fused program
   (``fused_executor_for_binaries``, which races even a small program) and
   the wide conv front end, each raced at construction; for each, the
   candidates, each measured candidate's build seconds and samples per
   second at the race batch, the skipped candidates with their bounds, the
   winner and the race's wall seconds; a second construction answered from
   memory and a third, the in-process decisions cleared, from the file
   (``run.autotune`` unchanged, ``run.mode_cache_hit`` up by two); each
   skipped candidate whose bound is at most ``AUTO_TIMED_BOUND_S`` timed
   once at the race batch, above its bound and slower than the winner; the
   winner at the full sample count equal to the reference interpreter (the
   flagship, config 5 and the wide conv on the samples of phases 5, 9 and
   11, held to the outputs those phases held to it), timed with CUDA
   events, and K1 forced beside it where the winner is not K1; phase 17's full-size
   times of the skipped modes beside their bounds; a synth program under
   ``AUTOTUNE_MIN_OPS`` ops taking the static answer (K1) without a race;
   a child process (``chip_smoke.py --auto-child FILE``) answered from the
   same decisions with no race. It runs beside the twin's g++ build, after
   phase 17;
19. the resident rung ladder (``run_resident``): the device search's
   default ladder, whose state stays on the card between rungs, against
   the host-state one (``DA4ML_JAX_DEVICE_RESIDENT=0``), the solve cache
   bypassed: the flagship at ``'fast'`` solved eight times in turns, each
   byte-identical to phase 4's program with as many K2 launches; every
   finished lane's fetched digits held to the host replay
   (``torch_search._replay_digits``), the replay's seconds beside those of
   the ladder's own fetches; the flagship at ``'search'`` on both ladders, the
   wider layers host-state and config 5 twice on each ladder, in turns (for
   the walls and peak device memory), each equal to phase 15's, 7's and 9's
   solve with the same K2 launches; a flagship solve whose ``DEVICE_BUDGET``
   (``SPILL_BUDGET``) splits later rungs, so that the carry spills to host
   state. Each solve's wall, K2 launches, uploaded and fetched bytes,
   resident rungs and emission waits are printed; its K2 launches are
   comparison launches, outside the kernel table. It runs beside the
   twin's g++ build, after phase 18;
20. the command line, each step ``python -m da4ml_tpu_torch`` in a child
   process with its exit code checked: the flagship saved as ``.json`` and
   converted to HLS projects (``vitis``, ``hlslib``, ``oneapi``) equal to
   the JAX package's (``CLI_DIGESTS``), then converted with
   ``--validate-rtl`` on ``CLI_FLAGSHIP_SAMPLES`` samples (K1 against the
   g++ emulator); the config-5 twin saved with ``torch.save`` and
   converted through the device search (K2) to an HLS project equal to the
   JAX package's, its ``pipeline.json`` converted with ``--validate-rtl`` on
   ``CLI_TWIN_SAMPLES`` samples (these two start right after phase 1:
   the g++ build of the twin's emulator is the run's longest step);
   ``verify --conformance`` of the twin's project and ``verify --fuzz``
   (numpy, cpp and the executor's four modes, K1 among them, against the
   reference interpreter, and the transfer-soundness sweep) ok; ``verify --json`` of a corrupted program
   equal to the JAX package's (``VERIFY_DIGEST``); ``lint-opcodes`` ok. In
   this process, the same ``convert`` of the twin with every rung call held
   to K2's plain version, K1 on both programs, the emulator the command
   line built held to K1, and the g++ build, emulator and K1 times
   (``cli_flagship``, ``cli_twin``);
21. checks that neither jax nor da4ml_tpu was imported.

The run keeps its ``mode='auto'`` decisions in a fresh temporary directory
(``DA4ML_TORCH_CACHE``, set before anything is built and inherited by every
child), so no run reads another run's decisions. Every phase but the 18th
runs with ``DA4ML_RUN_MODE=pallas``, which replaces only ``'auto'``: the
executors those phases build with the default mode, and the command line's
children, keep K1 as they did before ``mode='auto'`` raced.

Every count is set to 0 just before its path is driven and read just after;
the kernel line gives each kernel's main-path launches summed over the
paths and by path (K1's pipeline modes as ``fusion_<mode>`` and
``pipeline_model_<mode>``, the firmware phase as ``firmware_flagship`` and
``firmware_twin``, the command line's as ``cli_flagship`` and ``cli_twin``:
its in-process calls, since a child's counts stay in the child; the quality
search's as ``quality_flagship_<q>``, ``quality_corpus`` and
``quality_config5``; the telemetry phase's as ``telemetry_profile`` (the
profile child's wrapper counts, reset in the child just before its solves
and calls and read just after), ``telemetry_overhead`` and
``telemetry_endpoint``; the convert child's launches stay in the child;
the executor-modes phase's as ``modes_flagship``, ``modes_corpus``,
``modes_config5`` and ``modes_twin``, only the forced ``mode='pallas'`` calls whose outputs are
checked; the ``mode='auto'`` phase's as ``auto_<program>``: the race's K1
candidate calls and the full-size call, whichever mode won; the resident
ladder phase's re-solves are comparison launches, printed and not counted).

Prints the wall time of each phase, the kernel table as one JSON line,
the card line, and last
``{"ok": true, "device": {...}}``. Exits non-zero without that line when
there is no CUDA device or any phase fails.

Usage: ``python3 chip_smoke.py`` from the repository root (one card).
``python3 chip_smoke.py --profile-child DIR`` is the telemetry phase's
profile run, started by the phase itself.
``python3 chip_smoke.py --auto-child FILE`` is the ``mode='auto'`` phase's
child, started by the phase itself.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import platform
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

#: published H100 SXM peaks (NVIDIA data sheet / Hopper white paper) used
#: for the kernels' bounds: HBM3 bandwidth; int32 ALU issue = 132 SMs x
#: 64 INT32 lanes x 1.98 GHz boost clock; fp32 issue = 132 SMs x 128 FP32
#: lanes x 1.98 GHz (the data sheet's 67 TFLOP/s counts an FMA as two)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP32_OPS_PER_S = 132 * 128 * 1.98e9
#: shared-memory bandwidth, 132 SMs x 128 B/clk x 1.98 GHz (reported beside
#: the bound: the kernel reads two operands and writes one result per op)
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9

FLAGSHIP_SAMPLES = 1 << 20
#: samples of the flagship run through the vectorized numpy interpreter
NUMPY_SAMPLES = 1 << 16
#: the device budget of the resident-ladder phase's spilling solve: the
#: flagship's first rungs of each group fit it whole, later ones split
#: (``torch_search._rung_bytes_per_lane``), so the carry spills first
SPILL_BUDGET = 4 << 20
#: the ladders' order in the resident-ladder phase's timed solves: each
#: ladder first and last in turn, so drift favours neither
LADDER_TURNS = (True, False, False, True)
#: samples of the flagship run through ``run_binary`` by the OpenMP phase
OMP_SAMPLES = 1 << 18
CORPUS_BATCHES = (33, 1000, 131073)
#: the wider JEDI-MLP layers of bench.py (section 2_jedi_mlp_layers), six-bit
WIDE_LAYERS = ((16, 64), (64, 32), (32, 32), (32, 5))
#: samples of the config-5 model through K1; its plain version runs them
#: in chunks (its buffer is ops x rows: 19611 x 2^16 int32 is 5 GB), and the
#: reference interpreter checks the first 2^16 (its Python loop over the
#: ops takes about 20 s for those on a host CPU)
MODEL_SAMPLES = 1 << 20
MODEL_PLAIN_ROWS = 1 << 16
MODEL_REF_SAMPLES = 1 << 16
#: sha256 of the config-5 model's DAIS binary (little-endian int32) as the
#: JAX package traces it (``bench.py``'s ``_trace_model(limited=False)``, on
#: the CPU) with the native solver and with its device search. The two
#: solvers give different programs of the same function at this size (19611
#: ops, cost 181284, and 19610 ops, cost 181417); the port's 'cpp' and
#: 'torch' traces must each equal the reference's with the same solver
CONFIG5_DIGESTS = {'cpp': 'cd42f8ba2e17284848530e13056d905110beaa3902aee0775fd06ec85aed4095',
                   'jax': 'f78231fdd335658332b5492af27b1d8fb5b8caae46c9627cc07214c672de1024'}  # fmt: skip
#: sha256 of each fusion workload's stages (their DAIS binaries, little-endian
#: int32, one after another; ``stages_digest``) as the JAX package cuts them
#: (``bench.py``'s ``_run_fusion_workloads(limited=False)``), traced with its
#: device search or with its native solver: both give these bytes
FUSION_DIGESTS = {'conv_stack': '7cf00977d1318dfafd228253c413275aa95761035eb5f85b2c51649222bc4a6a',
                  'transformer_block': '673ccbb34acf754becf5aebff1c5940a631b44d8848ff8f07e25654f30d7a25b'}  # fmt: skip
#: samples of each fusion workload through its stages
FUSION_SAMPLES = 1 << 16
#: samples of the 256x256 conv front end through K1's 24-bit-field route
WIDE_CONV_SAMPLES = 2048
#: rows of a chunk of the reference interpreter's checks (``reference_stages``):
#: each host thread's share of the rows, clamped to these bounds: smaller
#: chunks run mostly in Python, under the GIL; larger ones only grow the
#: buffer (ops x rows of int64) each thread holds
REF_CHUNK_ROWS = (1 << 14, 1 << 15)
#: the executor-modes phase: rows of the flagship's outputs held to the
#: reference interpreter; the synth corpus's batch (odd, over one tile) and
#: programs (seed, ops, wide); config 5's and the int64 twin's samples in each
#: mode, and their rows held to the reference interpreter
MODES_REF_SAMPLES = 1 << 16
MODES_CORPUS_SAMPLES = 4099
MODES_CORPUS = tuple((seed, 300, seed % 2 == 1) for seed in range(8))
MODES_CONFIG5_SAMPLES = 1 << 16
MODES_CONFIG5_REF_SAMPLES = 4096
MODES_TWIN_SAMPLES = 1 << 14
MODES_TWIN_REF_SAMPLES = 4096
#: the mode='auto' phase: the synth program under ``AUTOTUNE_MIN_OPS`` ops
#: (its op count and samples), and the environment every other phase and
#: the command line's children run with; a skipped candidate is timed at
#: the race batch when its bound is at most AUTO_TIMED_BOUND_S seconds
AUTO_SYNTH_OPS = 600
AUTO_TIMED_BOUND_S = 0.05
AUTO_SYNTH_SAMPLES = 4096
PINNED_ENV = {'DA4ML_RUN_MODE': 'pallas'}
#: calls of the flagship's ``DaisExecutor.__call__`` each held to the one-launch route
BOUNDARY_REPEATS = 20
#: values beyond each integer type's range that the card's conversion must map
#: as numpy's cast on the host does
OUT_OF_RANGE = {32: (3e9, -3e9, 1e12, -1e12, 1e300, -1e300), 64: (1e19, -1e19, 1e300, -1e300)}
#: samples of ``bench.py``'s pipeline model (its ``_run_inference_micro(limited=False)``)
PIPELINE_SAMPLES = 262144
#: launches of each fusion workload's fused program on the same inputs
FUSED_REPEATS = 200
#: sha256 of each fusion workload's fused program (``fuse_binaries`` of its
#: stages, little-endian int32) as the JAX package fuses the stages of
#: ``FUSION_DIGESTS``
FUSED_DIGESTS = {'conv_stack': 'a9df9720200bd782ac8d50b105ac4b984229defc1fe315ac11d6260e594c579d',
                 'transformer_block': '11149b1fbeb18484235367e2788275a47c5cbc2a423ef4d69ab9d1483f52b3ed'}  # fmt: skip


#: the latency cutoff the firmware phase cuts its programs at (the README's quick start)
FIRMWARE_CUTOFF = 5
#: ``project_digest`` of the HDL projects the JAX package writes (on the CPU,
#: ``tools/firmware_digests.py``) with ``latency_cutoff=FIRMWARE_CUTOFF`` and
#: ``register_layers`` 1: the flagship in Verilog and in VHDL, and the
#: config-5 twin's device-search trace in Verilog
PROJECT_DIGESTS = {'verilog': '12356cc308e1119644693c2167c42fb4832644df368348867dcfe4ebe4a5294b',
                   'vhdl': 'd2c3ab14293501704a73701df795edc591cafd48106ee9033965deebd2c931fd',
                   'twin_verilog': 'e91afd28b098efc5ec31d8f48ecc5b40dae14a7d41105279547c7344e5679b22'}  # fmt: skip
#: sha256 of the config-5 twin's DAIS binary (``da4ml_tpu_torch.models.config5_twin``,
#: little-endian int32) as the JAX package's ``trace_model`` traces it with
#: its native solver (19422 ops) and with its device search (19436 ops): two
#: programs of the same function (``tools/firmware_digests.py``)
TWIN_DIGESTS = {'cpp': 'ac8580826eeada68b5f33eedc3a2c1265d62c1f84723cff7539cb498619df2bd',
                'jax': 'd01cb09c52b2197bc4f23692ec110194485eb0d6e9d93b3e0883aa3759680d90'}  # fmt: skip
#: samples of the flagship and the twin through K1 in the firmware phase
FIRMWARE_SAMPLES = 1 << 20
#: samples of the twin held to the module's own float64 forward and to the
#: reference interpreter (all its samples are held to the native one)
TWIN_FORWARD_SAMPLES = 4096
#: samples through the netlist simulators: the flagship's projects, the twin's
FLAGSHIP_NETLIST_SAMPLES = 256
TWIN_NETLIST_SAMPLES = 16
#: ``project_digest`` of the HLS projects the JAX package's ``convert`` writes
#: at its defaults (latency cutoff 5; ``tools/firmware_digests.py``): the
#: flagship saved as ``.json`` in the ``vitis`` (``--flavor hls``), ``hlslib``
#: and ``oneapi`` flavours, and the config-5 twin saved with ``torch.save``
#: and converted through the device search (``--solver-backend jax``, with
#: ``convert``'s ``hard_dc=2``) with ``--inputs-kif 1 3 2 -n 0``
CLI_DIGESTS = {'hls': 'fee82d4f60a9f8fe82712cb261651fb97734b0902bf0f2d8de5d5ac569a2c4a4',
               'hlslib': '70fa3846e60f7eac796f3a8255afe398c811d84c9f4faaebef4476a85ea10940',
               'oneapi': '9a812cc074afe934a33c6ecea4d714ec666ce59d3bda603bdd2d6f703ee127e2',
               'twin_hls': 'ec65b077ebbd40f4cf1667c7d6d35e11cda1ece9646b2d1e9c5f57385039c67c'}  # fmt: skip
#: sha256 of the standard output of the JAX package's ``verify corrupted.json
#: --json`` on ``corrupted_mul_program()`` (``tools/firmware_digests.py``)
VERIFY_DIGEST = 'd6bcd114a047d274bd846f28695038328540e3ef59ef9d814d4cddef558589bf'
#: samples ``convert --validate-rtl`` runs through K1 and the g++ emulator:
#: the flagship's, the twin's (cut from 2^20 to bound the run's time)
CLI_FLAGSHIP_SAMPLES = 1 << 20
CLI_TWIN_SAMPLES = 1 << 18
#: ``verify --conformance --samples`` on the twin's project, ``verify --fuzz``
CLI_CONFORMANCE_SAMPLES = 4096
CLI_FUZZ = 20
#: the JAX package's quality-search results on the CPU
#: (``tools/quality_digests.py``): sha256 of the flagship's DAIS binary
#: traced with ``{'backend': 'jax', 'quality': q}``, the costs of
#: ``ci/quality_corpus.npz``'s kernels (sorted by name) at 'search', the
#: config-5 model's 'search' trace, and the config-5 twin's Verilog project
#: from ``convert --solver-backend jax --quality search``
QUALITY_DIGESTS = {'fast': '7009d41dfc569cba46fd487e19307d42d87a363330625bdc666b6b94f848c264',
                   'search': '4fcc046785b020f04ce01a8a95c0e6e6ca0214a2f74dc600d77e801722ba7321',
                   'max': 'ce604ad483b516ff39cf29941e7fe30985dd7b39469e75d77efc161981e02463',
                   'config5': '692a271dac1634f0a4db2ff5d4ca34d8f860743fc8328c90cdc0360ec723a503',
                   'twin_cli': '4b8a2ec2b6eb6157d165744d5aed38180021a2a32376090178add2eb45a1ab57'}  # fmt: skip
QUALITY_CORPUS_COSTS = [97.0, 146.0, 118.0, 177.0, 243.0, 192.0, 241.0, 150.0]
#: samples of each quality-search flagship program through K1, and of them
#: held to the reference interpreter
QUALITY_SAMPLES = 1 << 20
QUALITY_REF_SAMPLES = 1 << 16
#: config 5's fork rung calls held to K2's plain version (its plain version
#: is slow at config 5's sizes)
CONFIG5_FORK_CHECKS = 4
#: flagship calls timed with telemetry off and on (``telemetry_overhead``)
TELEMETRY_REPEATS = 9


def project_digest(root) -> str:
    """sha256 over an HDL project's files, sorted by their paths relative to
    ``root``: for each file its relative path (UTF-8) and then its bytes,
    each preceded by its length as 8 little-endian bytes."""
    from pathlib import Path

    root = Path(root)
    h = hashlib.sha256()
    for path in sorted(p for p in root.rglob('*') if p.is_file()):
        for part in (path.relative_to(root).as_posix().encode(), path.read_bytes()):
            h.update(len(part).to_bytes(8, 'little'))
            h.update(part)
    return h.hexdigest()


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True,
    ).stdout  # fmt: skip
    return out.strip().splitlines()[0]


def cpu_model() -> str:
    """The host CPU's model name as ``lscpu`` gives it, and the machine's
    architecture (host times are read on its clock)."""
    try:
        out = subprocess.run(['lscpu'], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):  # no lscpu: the kernel's own list
        with open('/proc/cpuinfo') as f:
            out = f.read().replace('model name\t:', 'Model name:')
    names = [line.split(':', 1)[1].strip() for line in out.splitlines() if line.startswith('Model name:')]
    return f"{names[0] if names else 'no model name'} ({platform.machine()})"


def gxx_version() -> str:
    return subprocess.run(['g++', '--version'], capture_output=True, text=True, check=True).stdout.splitlines()[0]


def same_solution(a, b) -> bool:
    """Two pipelines are the same solution, op for op."""
    return len(a.stages) == len(b.stages) and all(
        list(sa.ops) == list(sb.ops) and list(sa.out_idxs) == list(sb.out_idxs)
        and list(sa.out_shifts) == list(sb.out_shifts) and list(map(bool, sa.out_negs)) == list(map(bool, sb.out_negs))
        and list(sa.inp_shifts) == list(sb.inp_shifts)
        for sa, sb in zip(a.stages, b.stages)
    )  # fmt: skip


def cuda_ms(fn, reps: int, fresh=None) -> float:
    """Median milliseconds of ``reps`` calls, each timed with CUDA events,
    after one untimed warm call. ``fresh()``, when given, makes each call's
    arguments outside the timed span (for a function that updates them in
    place)."""
    import torch

    fn(*(fresh() if fresh else ()))
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        args = fresh() if fresh else ()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def print_ptxas(log: str) -> None:
    for line in log.splitlines():
        if 'Function properties' in line or 'registers' in line or 'spill' in line:
            print('  ptxas:', line.strip())


def k2_ptxas(log: str) -> dict[tuple[int, bool], tuple[int, int]]:
    """ptxas' (registers, stack frame bytes) of each K2 instantiation, keyed
    by (K, global placement)."""
    out, key, stack = {}, None, 0
    for line in log.splitlines():
        if m := re.search(r'fused_cse_kernelILi(\d+)ELb([01])E', line):
            key = (int(m[1]), m[2] == '1')
        elif (m := re.search(r'(\d+) bytes stack frame', line)) and key:
            stack = int(m[1])
        elif (m := re.search(r'Used (\d+) registers', line)) and key:
            out[key], key = (int(m[1]), stack), None
    return out


def k1_ptxas(log: str) -> dict[tuple[int, bool, bool], dict[str, int]]:
    """ptxas' registers, spill stores and loads and stack frame of each K1
    instantiation, keyed by (itemsize, global-memory buffer, 24-bit fields)."""
    out, key, info = {}, None, {}
    for line in log.splitlines():
        if m := re.search(r'dais_exec_kernelI([il])Lb([01])ELb([01])E', line):
            key, info = (4 if m[1] == 'i' else 8, m[2] == '1', m[3] == '1'), {}
        elif (m := re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads', line)) and key:
            info = {'stack': int(m[1]), 'spill_stores': int(m[2]), 'spill_loads': int(m[3])}
        elif (m := re.search(r'Used (\d+) registers', line)) and key:
            out[key], key = {'registers': int(m[1]), **info}, None
    return out


def k1_shape(torch, ex, ptxas) -> tuple[str, dict]:
    """K1's launch shape for one program on card 0, as one line and a dict:
    slots, phases, tiles per block, warps per tile (G), record layout (16- or
    24-bit slot fields) and bytes (the record and, per op on average, what
    it reads of its pool entry), resident warps per SM (the occupancy API),
    buffer path, ptxas' report of the instantiation it runs."""
    card = torch.device('cuda', 0)
    k = ex.kernel
    d, g = k.data, k.geometry(card)
    path = f'global scratch, {g.scratch_rows} rows a launch' if g.scratch_rows else 'shared memory'
    shape = {'slots': d.n_slots, 'phases': len(d.phases), 'tiles': g.tiles, 'warps': g.warps,
             'field_bits': d.field_bits, 'record_bytes': k.record_bytes, 'resident_warps': k.occupancy(card),
             'smem': g.smem, 'global': g.scratch_rows is not None,
             **ptxas[k.itemsize, g.scratch_rows is not None, d.field_bits == 24]}  # fmt: skip
    line = (f"{k.n_ops} ops, {ex.dtype}, {shape['slots']} slots, {shape['phases']} phases, {g.tiles} tiles x "
            f"{g.warps} warps a block, {d.field_bits}-bit slot fields, {shape['record_bytes']:.2f} record and pool "
            f"bytes an op, {g.smem} B shared memory a block, "
            f"{shape['resident_warps']} resident warps per SM (occupancy API), {path}; ptxas {shape['registers']} "
            f"registers, {shape['spill_stores']}/{shape['spill_loads']} B spill stores/loads")  # fmt: skip
    return line, shape


def k1_mismatch(torch, ex, prog, data, x, y_kernel, y_plain, run_program) -> str:
    """What a K1 result that differs from its plain version looks like: the
    words, rows and tiles that differ, whether the kernel's and the plain
    version's rows equal the reference interpreter, and whether a second
    launch reproduces the difference."""
    rows = (y_kernel != y_plain).any(1).nonzero().flatten()
    ref = run_program(prog, data[rows.cpu().numpy()])
    scale = ex._out_scale()
    kernel_ok = np.array_equal(y_kernel[rows].cpu().numpy().astype(np.float64) * scale, ref)
    plain_ok = np.array_equal(y_plain[rows].cpu().numpy().astype(np.float64) * scale, ref)
    again = torch.equal(ex.kernel.launch(x), y_plain)
    tiles = sorted({r // 32 for r in rows.tolist()})
    return (f'{int((y_kernel != y_plain).sum())} words differ in {len(rows)} rows, tiles {tiles[:20]} '
            f'({len(tiles)} tiles); on those rows the kernel equals the reference interpreter: {kernel_ok}, the '
            f'plain version: {plain_ok}; a second launch equals the plain version: {again}')


def check_corpus(torch, DaisExecutor, cuda_backend, run_program, ptxas) -> None:
    from da4ml_tpu_torch.ir.synth import FAMILIES, random_inputs, random_program

    rng = np.random.default_rng(20261016)
    corpus = [(f'family {f}', random_program(rng, n_ops=160, n_in=5, n_out=4, families=(f,))) for f in FAMILIES]
    corpus += [(f'mixed {k}', random_program(rng, n_ops=400, n_in=8, n_out=6)) for k in range(2)]
    corpus += [(f'wide {k}', random_program(rng, n_ops=400, n_in=8, n_out=6, wide=True)) for k in range(3)]
    # 482 int32 slots: a block of 67568 bytes of shared memory, over 48 KB,
    # which launches only with the dynamic-size opt-in
    corpus.append(('smem over 48K', random_program(np.random.default_rng(1), n_ops=1500, n_in=8, n_out=6, n_levels=5)))
    # phases of at most 2 ops: one warp a tile, two tiles a block, each warp on
    # its own named barrier
    corpus.append(('two tiles a block', random_program(np.random.default_rng(0), n_ops=20, n_in=2, n_out=2,
                                                       n_levels=18)))  # fmt: skip
    # about a thousand int64 slots: a tile too wide for shared memory, so the
    # kernel keeps its buffers in global memory, in chunks
    corpus.append(('global scratch', random_program(np.random.default_rng(1), n_ops=3200, n_in=8, n_out=6,
                                                    n_levels=3, wide=True)))  # fmt: skip
    # slot fields over 16 bits, so the 24-bit-field layout: a copy's input
    # column over 0xFFFF, and two levels of add/sub whose first stays live
    # through the second, over 65535 slots on the global-memory path
    long_fields = ('65537 inputs', 'over 65535 slots')
    corpus.append((long_fields[0], random_program(np.random.default_rng(0), n_in=65537, n_ops=65737,
                                                  families=('add',))))  # fmt: skip
    corpus.append((long_fields[1], random_program(np.random.default_rng(3), n_in=8, n_ops=170000, n_out=6, n_levels=2,
                                                  families=('add',))))  # fmt: skip
    assert sum(ex_prog.max_width + 2 > 31 for _, ex_prog in corpus) >= 2, 'corpus must hold two wide int64 programs'
    n_checked = 0
    for name, prog in corpus:
        ex = DaisExecutor(prog, device='cuda')
        line, shape = k1_shape(torch, ex, ptxas)
        if name == 'smem over 48K':
            assert ex.dtype == torch.int32 and shape['smem'] > 48 * 1024 and not shape['global'], shape
        assert shape['global'] == (name in ('global scratch', *long_fields)), f'corpus {name}: {shape}'
        assert (shape['field_bits'] == 24) == (name in long_fields), f'corpus {name}: {shape}'
        if name == long_fields[1]:
            assert shape['slots'] > 0xFFFF, shape
        assert (shape['tiles'] > 1) == (name == 'two tiles a block'), f'corpus {name}: {shape}'
        assert shape['resident_warps'] > 0, f'corpus {name}: the kernel cannot launch ({shape})'
        # the plain version's buffer is ops x batch: the long programs skip
        # the largest batch
        for batch in CORPUS_BATCHES[:2] if name in long_fields else CORPUS_BATCHES:
            data = random_inputs(rng, prog, batch)
            x = ex.int_inputs(data)
            y_kernel = ex.kernel.launch(x)
            y_plain = ex.plain(x)
            torch.cuda.synchronize()
            if not torch.equal(y_kernel, y_plain):
                raise AssertionError(f'corpus {name} batch {batch}: ' + k1_mismatch(torch, ex, prog, data, x, y_kernel,
                                                                                     y_plain, run_program))  # fmt: skip
            if batch == 1000:
                got = y_kernel.cpu().numpy().astype(np.float64) * ex._out_scale()
                if not np.array_equal(got, run_program(prog, data)):
                    raise AssertionError(f'corpus {name}: kernel disagrees with the reference interpreter')
            n_checked += 1
        print(f'corpus {name}: {line}: equal', flush=True)
    assert cuda_backend.scratch_launches > 0, 'no corpus program took the global-memory path'
    print(f'corpus: {n_checked} (program, batch) cases bit-exact; scratch launches {cuda_backend.scratch_launches}')


#: K1's phase sizes and warps per tile timed beside the kept pair
#: (``cuda_backend.PHASE_OPS``, ``MAX_WARPS``): a phase per level, shorter
#: phases, fewer and more warps
K1_ALTERNATIVES = ((10**9, 6), (64, 6), (128, 6), (192, 4), (192, 8))


def k1_scheme_scan(torch, prog, x, y_plain, ptxas, card: str) -> None:
    """K1 on the flagship with the host's phase size (``PHASE_OPS``) and
    warps per tile (``MAX_WARPS``) at the kept pair and each of
    ``K1_ALTERNATIVES``: the same kernel build, other phases, slots and launch
    shape. Each must equal the plain version; prints slots, phases, the
    launch shape and ms, in turns (each pair timed twice, the order reversed
    the second time)."""
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    schemes = ((cuda_backend.PHASE_OPS, cuda_backend.MAX_WARPS), *K1_ALTERNATIVES)
    runs = {}
    for phase_ops, warps in schemes:
        consts = {(cuda_backend, 'PHASE_OPS'): lambda _, v=phase_ops: v, (cuda_backend, 'MAX_WARPS'): lambda _, v=warps: v}
        with Patched(consts):
            ex = DaisExecutor(prog)
            assert torch.equal(ex.kernel.launch(x), y_plain), f'K1 with {phase_ops}-op phases, {warps} warps'
            runs[phase_ops, warps] = (ex, consts, k1_shape(torch, ex, ptxas)[1], [])
    for order in (schemes, schemes[::-1]):
        for key in order:
            ex, consts, _, times = runs[key]
            with Patched(consts):
                times.append(cuda_ms(lambda: ex.kernel.launch(x), reps=10))
    for (phase_ops, warps), (ex, _, shape, times) in runs.items():
        label = 'a phase per level' if phase_ops >= 10**9 else f'phases of at most {phase_ops} ops'
        print(f"[{card}] K1 scheme, {label}, {warps} warps a tile: {shape['slots']} slots, {shape['phases']} phases, "
              f"{shape['tiles']} x {shape['warps']} warps a block, {shape['resident_warps']} resident warps per SM: "
              f"{', '.join(f'{t:.4f}' for t in times)} ms, equal")  # fmt: skip


def host_runtimes(comb, data, y) -> None:
    """The host runtimes on K1's inputs: ``run_comb(backend='cpp')`` on all of
    them, ``'numpy'`` on the first 2^16; each must equal K1's output ``y``
    bit for bit. Prints their host seconds."""
    from da4ml_tpu_torch.runtime import run_comb

    t0 = time.perf_counter()
    y_cpp = run_comb(comb, data, backend='cpp')
    t1 = time.perf_counter()
    y_np = run_comb(comb, data[:NUMPY_SAMPLES], backend='numpy')
    t2 = time.perf_counter()
    assert np.array_equal(y_cpp, y), "run_comb(backend='cpp') disagrees with K1"
    assert np.array_equal(y_np, y[:NUMPY_SAMPLES]), "run_comb(backend='numpy') disagrees with K1"
    print(f"host runtimes (host clock, {cpu_model()}): 'cpp' {t1 - t0:.4f} s for {len(data)} samples "
          f"(OpenMP's default thread count), 'numpy' {t2 - t1:.4f} s for {NUMPY_SAMPLES} samples; both bit-equal "
          f"to K1's output")  # fmt: skip


def gomp_maps() -> list[str]:
    """The OpenMP runtimes (libgomp files) mapped into this process."""
    with open('/proc/self/maps') as f:
        return sorted({line.split()[-1] for line in f if 'gomp' in line.split()[-1]})


def native_timings(native, job: dict, wide: bool) -> dict:
    """Host seconds of the native library's OpenMP calls on ``job``: the
    flagship's ``run_binary`` (twice), a replay of the device search's
    ``emit_batch`` calls (five times) and, with ``wide``, ``solve_native`` on
    the wider layers; and what they returned, to compare across processes."""
    secs: dict[str, list[float]] = {'run_binary': [], 'emit_batch': [], 'solve_native': []}
    for _ in range(2):
        t0 = time.perf_counter()
        y = native.run_binary(job['binary'], job['data'])
        secs['run_binary'].append(time.perf_counter() - t0)
    for _ in range(5):
        t0 = time.perf_counter()
        emit_costs = [s.cost for args, kw in job['emit'] for s in native.emit_batch(*args, **kw)]
        secs['emit_batch'].append(time.perf_counter() - t0)
    wide_costs = []
    for k in job['wide'] if wide else ():
        t0 = time.perf_counter()
        wide_costs.append(float(native.solve_native(k).cost))
        secs['solve_native'].append(time.perf_counter() - t0)
    digest = hashlib.sha256(y.tobytes()).hexdigest()
    return {'seconds': secs, 'y': digest, 'emit_costs': emit_costs, 'wide_costs': wide_costs}


def omp_child(job_path: str, wide: bool) -> dict:
    """The child side of :func:`openmp_check`: the library loaded without
    torch, so the process holds one OpenMP runtime, whose
    ``omp_get_max_threads()`` is read through the library's handle."""
    from da4ml_tpu_torch import native

    lib = native.load_lib()
    assert lib is not None, native.load_error()
    with open(job_path, 'rb') as f:
        job = pickle.load(f)
    out = native_timings(native, job, wide)
    assert 'torch' not in sys.modules, 'the child process imported torch'
    return {**out, 'omp_max_threads': lib.omp_get_max_threads(), 'gomp': gomp_maps()}


def openmp_check(torch, native, native_build, comb, emit_calls: list, wide_kernels: list) -> None:
    """The library's OpenMP calls in this process (CUDA torch loaded, its own
    OpenMP runtime) against the same calls in child processes without torch,
    at the default thread count and with ``OMP_NUM_THREADS=1``: a hang or an
    oversubscription beside torch shows as a stall or as this process's
    default being slower than the child's. Every process's outputs must
    agree."""
    binary = comb.to_binary()
    data = np.random.default_rng(20261017).uniform(-8, 8, (OMP_SAMPLES, comb.shape[0]))
    job = {'binary': binary, 'data': data, 'emit': emit_calls, 'wide': wide_kernels}
    path = native_build.lib_path().parent / f'openmp_check_{os.getpid()}.pkl'
    with open(path, 'wb') as f:
        pickle.dump(job, f)
    try:
        here = native_timings(native, job, wide=True)
        one = []
        for _ in range(2):
            t0 = time.perf_counter()
            native.run_binary(binary, data, n_threads=1)
            one.append(time.perf_counter() - t0)
        children = {}
        code = 'import json, sys, chip_smoke; print(json.dumps(chip_smoke.omp_child(sys.argv[1], sys.argv[2] == "1")))'
        here_dir = os.path.dirname(os.path.abspath(__file__))
        for label, env, wide in (('default', {}, '1'), ('OMP_NUM_THREADS=1', {'OMP_NUM_THREADS': '1'}, '0')):
            proc = subprocess.run([sys.executable, '-c', code, str(path), wide], cwd=here_dir, env={**os.environ, **env},
                                  capture_output=True, text=True, timeout=600)  # fmt: skip
            assert proc.returncode == 0, f'OpenMP child ({label}) failed:\n{proc.stderr[-4000:]}'
            children[label] = json.loads(proc.stdout.strip().splitlines()[-1])
    finally:
        path.unlink(missing_ok=True)
    free, single = children['default'], children['OMP_NUM_THREADS=1']
    for c in (free, single):
        assert c['y'] == here['y'] and c['emit_costs'] == here['emit_costs'], 'the native calls differ across processes'
    assert free['wide_costs'] == here['wide_costs'] and single['omp_max_threads'] == 1

    def fmt(xs):
        return ', '.join(f'{x:.4f}' for x in xs)

    print(f"OpenMP (host clock, {cpu_model()}): this process (CUDA torch, torch.get_num_threads() "
          f"{torch.get_num_threads()}) maps {gomp_maps()}; a child without torch maps {free['gomp']}, where the "
          f"library's omp_get_max_threads() is {free['omp_max_threads']} ({single['omp_max_threads']} with "
          f"OMP_NUM_THREADS=1); outputs equal in all three processes")  # fmt: skip
    print(f"OpenMP run_binary, flagship, {OMP_SAMPLES} samples (s): this process {fmt(here['seconds']['run_binary'])}, "
          f"n_threads=1 {fmt(one)}; without torch {fmt(free['seconds']['run_binary'])}, OMP_NUM_THREADS=1 "
          f"{fmt(single['seconds']['run_binary'])}")  # fmt: skip
    print(f"OpenMP emit_batch, the flagship search's {len(emit_calls)} calls replayed (s): this process "
          f"{fmt(here['seconds']['emit_batch'])}; without torch {fmt(free['seconds']['emit_batch'])}, "
          f"OMP_NUM_THREADS=1 {fmt(single['seconds']['emit_batch'])}")  # fmt: skip
    print(f"OpenMP solve_native, wider layers {WIDE_LAYERS} (s): this process {fmt(here['seconds']['solve_native'])}; "
          f"without torch {fmt(free['seconds']['solve_native'])}", flush=True)  # fmt: skip


def run_dais_flagship(torch, comb, card: str, ptxas) -> dict:
    """K1's main path: the flagship program on 2^20 samples, checked and
    timed; then the host runtimes on the same inputs."""
    from da4ml_tpu_torch.entry import entry
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    prog = decode(comb.to_binary())
    data = np.random.default_rng(20260729).uniform(-8, 8, (FLAGSHIP_SAMPLES, prog.n_in))
    ex = DaisExecutor(prog)
    assert ex.device.type == 'cuda' and ex.dtype == torch.int32
    cuda_backend.reset_counts()
    t0 = time.perf_counter()
    y = ex(data)
    t1 = time.perf_counter()
    fn, (x_entry,) = entry()
    y_entry = fn(x_entry)
    torch.cuda.synchronize()
    call_s, entry_s = t1 - t0, time.perf_counter() - t1
    launches = cuda_backend.launches
    print(f'flagship: main path launched the DAIS kernel {launches} times ({cuda_backend.scratch_launches} scratch)')
    assert launches > 0, 'the main path never launched the DAIS kernel'
    assert y.shape == (FLAGSHIP_SAMPLES, prog.n_out) and np.isfinite(y).all()

    x = ex.int_inputs(data)
    y_plain = ex.plain(x)
    y_kernel = ex.fn_int(x)
    torch.cuda.synchronize()
    assert torch.equal(y_kernel, y_plain), 'flagship: kernel disagrees with its plain version on the card'
    max_abs_err = float((y_kernel.double() - y_plain.double()).abs().max())
    assert np.array_equal(y, y_plain.cpu().numpy().astype(np.float64) * ex._out_scale())
    assert np.array_equal(y, reference_stages([prog], data)[0]), 'flagship: kernel disagrees with the reference interpreter'
    assert torch.equal(y_entry, ex.plain(x_entry)), 'entry(): kernel disagrees with its plain version'
    print(f'flagship: {FLAGSHIP_SAMPLES} samples bit-exact vs plain (card) and reference (host)')

    # host clock of DaisExecutor.__call__ on 2^20 float samples, by stage
    t0 = time.perf_counter()
    x_host = torch.from_numpy(ex._int_inputs(data))
    t1 = time.perf_counter()
    x_card = x_host.to(ex.device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    y_card = ex.fn_int(x_card)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    y_host = y_card.cpu().numpy()
    t4 = time.perf_counter()
    y_host.astype(np.float64) * ex._out_scale()
    t5 = time.perf_counter()
    print(f'flagship call: {call_s:.4f} s, the first through this executor (entry(): {entry_s:.4f} s, a new executor '
          f'on 64 rows); the one-launch route by stage: float->int {t1 - t0:.4f} s, H2D {t2 - t1:.4f} s, kernel '
          f'{t3 - t2:.4f} s, D2H {t4 - t3:.4f} s, int->float {t5 - t4:.4f} s')  # fmt: skip
    run_boundary(torch, ex, data, y, card)

    line, shape = k1_shape(torch, ex, ptxas)
    print(f'[{card}] flagship dais_exec: {line}')
    assert shape['resident_warps'] >= 24, f'flagship: {shape["resident_warps"]} resident warps per SM, want 24'
    compact = {cuda_backend.LOWERINGS[f] for f in cuda_backend.COMPACT}
    assert shape['field_bits'] == 16 and shape['record_bytes'] == 16, f'flagship records need the pool: {shape}'
    assert set(ex.kernel.data.fam.tolist()) <= compact, 'flagship records need the pool'
    ms = cuda_ms(lambda: ex.fn_int(x), reps=20)
    plain_ms = cuda_ms(lambda: ex.plain(x), reps=5)
    n_bytes, int_ops = ex.kernel.work(FLAGSHIP_SAMPLES)
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, int_ops / INT32_OPS_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')
    smem_ms = 3 * prog.n_ops * FLAGSHIP_SAMPLES * ex.kernel.itemsize / SMEM_BYTES_PER_S * 1e3
    print(f'[{card}] dais_exec: {ms:.4f} ms for {FLAGSHIP_SAMPLES} samples ({FLAGSHIP_SAMPLES / ms * 1e3:.4g} samples/s), '
          f'{prog.n_ops} ops, {ex.kernel.data.n_slots} slots, {len(ex.kernel.data.phases)} phases')  # fmt: skip
    print(f'[{card}] plain level version: {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {bound_by} '
          f'(int ALU {ops_ms:.4f} ms for {ex.kernel.data.int_ops_per_sample} operations per sample, HBM {bytes_ms:.4f} ms; '
          f'shared-memory traffic {smem_ms:.4f} ms)')  # fmt: skip
    print(f'[{card}] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    k1_scheme_scan(torch, prog, x, y_plain, ptxas, card)
    host_runtimes(comb, data, y)
    return {
        'name': 'dais_exec',
        'route': 'cuda',
        'source': 'da4ml_tpu_torch/csrc/dais_exec.cu',
        'replaces': 'da4ml_tpu/runtime/pallas_backend.py:480',
        'launches': launches,
        'max_abs_err': max_abs_err,
        'ms': ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': bound_by,
        'library_ms': None,
        'y': y,
    }


# ---------------------------------------------------------------------------
# K2: rungs of the device search
# ---------------------------------------------------------------------------


class Patched:
    """Replaces functions of modules while active: ``{(module, name): make}``,
    where ``make(real)`` returns the replacement of ``module.name``."""

    def __init__(self, makers):
        self.makers, self.saved = makers, {}

    def __enter__(self):
        for (mod, name), make in self.makers.items():
            self.saved[mod, name] = getattr(mod, name)
            setattr(mod, name, make(self.saved[mod, name]))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


class Laps:
    """Host-clock seconds between successive ``lap`` calls, by name (a name
    given again adds up)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self._t
        self._t = now

    def line(self) -> str:
        return ', '.join(f'{k} {v:.1f} s' for k, v in self.seconds.items())


def timed(seconds: dict, key: str, sync: bool = False):
    """A maker for :class:`Patched`: the function, its host seconds added to
    ``seconds[key]`` (ended by a device synchronize when ``sync``)."""

    def make(real):
        def fn(*args, **kw):
            import torch

            t0 = time.perf_counter()
            out = real(*args, **kw)
            if sync:
                torch.cuda.synchronize()
            seconds[key] += time.perf_counter() - t0
            return out

        return fn

    return make


class RungRecorder(Patched):
    """Records every ``torch_search.cse_rung`` call of a solve (inputs, spec;
    a tensor input is cloned, since the resident ladder hands K2 device
    tensors that it updates in place) and counts the calls of
    ``torch_search.init_cache`` meanwhile (on the card K2 builds the score
    cache itself). With ``stages``, also times the rung calls by stage on the
    host clock, each stage ended by a device synchronize: ``transition``
    (``torch_search._transition``: the resident ladder's gather of the next
    rung's state on the card), ``upload`` (``rung_inputs``), ``K2``
    (``fused_cse.greedy_loop``: the wrapper's checks and the launch) and
    ``fetch`` (the ladder's own fetches: ``_fetch_finished`` on a resident
    rung, ``_fetch_rung`` on a host-state or chunked one, ``_fetch_carry``
    on a spill). The stage timers add synchronizes of their own, so a run
    with them is not the one whose wall time is reported."""

    def __init__(self, ts, fused_cse, stages: bool = False):
        self.calls, self.init_cache_calls, self.stages = [], 0, stages
        self.seconds = dict.fromkeys(('transition', 'upload', 'K2', 'fetch'), 0.0)
        makers = {(ts, 'cse_rung'): self._record, (ts, 'init_cache'): self._count_init_cache}
        if stages:
            makers[ts, '_transition'] = timed(self.seconds, 'transition', sync=True)
            makers[ts, 'rung_inputs'] = timed(self.seconds, 'upload', sync=True)
            makers[fused_cse, 'greedy_loop'] = timed(self.seconds, 'K2', sync=True)
            for name in ('_fetch_finished', '_fetch_rung', '_fetch_carry'):
                makers[ts, name] = timed(self.seconds, 'fetch')
        super().__init__(makers)

    def _record(self, real):
        def cse_rung(E0, qmeta0, lat0, cur0, method, spec, device=None, copy=True):
            inputs = tuple(t.clone() if hasattr(t, 'clone') else t for t in (E0, qmeta0, lat0, cur0, method))
            self.calls.append((inputs, spec))
            return real(E0, qmeta0, lat0, cur0, method, spec, device, copy)

        return cse_rung

    def _count_init_cache(self, real):
        def init_cache(*args, **kw):
            self.init_cache_calls += 1
            return real(*args, **kw)

        return init_cache

    @property
    def total(self) -> float:
        return sum(self.seconds.values())


def counted(counts: dict, key: str, keep: list | None = None):
    """A maker for :class:`Patched`: the function, its calls counted in
    ``counts[key]`` (and their arguments appended to ``keep``)."""

    def make(real):
        def fn(*args, **kw):
            counts[key] += 1
            if keep is not None:
                keep.append((args, kw))
            return real(*args, **kw)

        return fn

    return make


def host_clock(ts, native) -> tuple[Patched, dict]:
    """Times the device search's host side: ``solve`` (all of
    ``solve_torch_many``), ``decomposition`` (kernel decomposition, native
    or Python, and each lane's CSD) and ``emission`` (each group's adder
    trees: one native ``emit_batch`` call, or each lane's state from its op
    records and its tree in Python; and the argmin winners' ``CombLogic``)."""
    seconds = dict.fromkeys(('solve', 'decomposition', 'emission'), 0.0)
    stages = {(ts, 'solve_torch_many'): 'solve', (ts, 'kernel_decompose'): 'decomposition',
              (native, 'decompose_batch'): 'decomposition', (ts, '_prepare_lane'): 'decomposition',
              (ts, '_host_state_from'): 'emission', (ts, 'to_solution'): 'emission',
              (native, 'emit_batch'): 'emission', (ts, '_as_comb'): 'emission'}  # fmt: skip
    return Patched({name: timed(seconds, key) for name, key in stages.items()}), seconds


def rung_work(ts, inputs, rec, cur, spec) -> dict[str, int]:
    """Bytes, and int32 and fp32 operations of the cache build and of the
    loop, that one rung needs for this run's data.

    Bytes: every input read once and every output written once; the score
    cache is built and kept on chip and moves none. Operations count only
    live slots (rows holding a nonzero digit; a check against an all-zero row
    finds nothing, and its candidates are invalid), L of them at a time.
    Cache build, per lane that runs: int32, every live row's nonzero digit at
    bit b meets each live slot once per shift that exists for it with the row
    first (B - b checks); fp32, one score and one top-K compare for each of
    the 2B·L·L candidates. Loop, per recorded iteration, over its d distinct
    dirty rows {i, j, cur} (two for an i == j chain), replayed from the
    iteration's record: int32, the exact recount, where a nonzero digit at
    bit b meets each live slot once per shift that exists for it in each
    operand order (B - b row first, b + 1 slot first), the shift-0 product
    the same in both orders: B checks; fp32, the argmax over the 2B·L cache
    heads, the scores of each dirty row's 2·(2B - 1)·L refreshed candidates
    (at shift 0 only one operand order is a candidate), one compare per
    refreshed column in the merge of each of the 2B·L cache rows (d·2B·L),
    one pass over each of the d·2B rebuilt rows of L scores.
    """
    import torch

    E0, _, _, cur0, _ = (x.cpu().numpy() if hasattr(x, 'cpu') else np.asarray(x) for x in inputs)
    N, P, O, B = E0.shape
    TB = 2 * B
    work = {'bytes': 2 * (N * P * O * B + 16 * N * P) + 12 * N + 16 * N * spec.n_iters,
            'int_build': 0, 'fp_build': 0, 'int_loop': 0, 'fp_loop': 0}  # fmt: skip
    run = np.flatnonzero(cur0 < P)  # a padding or frozen lane does nothing
    if not len(run):
        return work
    E = torch.from_numpy(E0[run].copy())
    lanes = torch.arange(len(run))
    start = torch.from_numpy(cur0[run].astype(np.int64))
    iters = torch.from_numpy((cur[run] - cur0[run]).astype(np.int64))
    steps = torch.from_numpy(rec[run].astype(np.int64))
    nz = E.ne(0)
    alive = nz.any(-1).any(-1)  # [lanes, P]: rows holding a nonzero digit
    live = alive.sum(-1)
    weight = B - torch.arange(B)  # a nonzero digit at bit b: B - b checks
    work['int_build'] += int((live * (nz * weight).sum((1, 2, 3))).sum())
    work['fp_build'] += int((2 * TB * live * live).sum())
    # every lane's t-th iteration at once: lanes are independent, and within a
    # lane the iterations are replayed in order
    for t in range(int(iters.max())):
        u = lanes[iters > t]
        id0, id1, sub, shift = steps[u, t].unbind(-1)
        i, j, s = torch.where(shift >= 0, id0, id1), torch.where(shift >= 0, id1, id0), shift.abs()
        c = start[u] + t
        E[u, c] = ts._dev_substitute(E, u, sub, s, i, j, B)  # the search's own substitution
        digits = [E[u, r].ne(0).sum((1, 2)) for r in (i, j, c)]
        for r, n_nz in zip((i, j, c), digits):  # only these rows changed
            alive[u, r] = n_nz > 0
        live = alive[u].sum(-1)
        dirty_nz = digits[0] + torch.where(i == j, 0, digits[1]) + digits[2]
        d = torch.where(i == j, 2, 3)  # the distinct rows {i, j, c}
        work['int_loop'] += int((B * live * dirty_nz).sum())
        work['fp_loop'] += int((TB * live + d * (2 * (TB - 1) * live + TB * live + TB * live)).sum())
    return work


def random_rung(rng, P: int, O: int, B: int, n_rows: int, N: int = 7):
    """Seeded random trit lanes of one rung class: methods 0-5 and a padding
    lane (cur0 = P); lane 0's first row is a run of equal digits, which the
    search matches as an i == j chain."""
    E = np.zeros((N, P, O, B), np.int8)
    E[:, :n_rows] = rng.choice([-1, 0, 0, 1], size=(N, n_rows, O, B)).astype(np.int8)
    E[0, 0] = 1
    q = np.zeros((N, P, 3), np.float32)
    q[:, :, 2] = 1.0
    st = 2.0 ** -rng.integers(0, 3, (N, n_rows))
    q[:, :n_rows, 0] = -rng.integers(0, 64, (N, n_rows)) * st
    q[:, :n_rows, 1] = rng.integers(1, 64, (N, n_rows)) * st
    q[:, :n_rows, 2] = st
    lat = np.zeros((N, P), np.float32)
    lat[:, :n_rows] = rng.integers(0, 3, (N, n_rows))
    cur = np.full(N, n_rows, np.int32)
    cur[-1] = P
    return E, q, lat, cur, (np.arange(N) % 6).astype(np.int32)


def k2_geometry(torch, fused_cse, P: int, O: int, B: int, K: int, ptxas) -> dict:
    """K2's launch shape for a rung class on card 0: cluster size, block
    size, placement, shared memory per block (the slice when it lives there,
    and the static arrays), clusters the card holds at once, and ptxas'
    registers and stack frame of the instantiation it runs."""
    card = torch.device('cuda', 0)
    C, threads, placement = fused_cse.cluster_geometry(P, O, B, K, fused_cse.device_smem(card))
    slice_bytes = fused_cse.slice_layout(P, O, B, K, C)['bytes']
    dyn = slice_bytes if placement == 'shared' else 0
    regs, stack = ptxas.get((K, placement == 'global'), (None, None))
    return {'C': C, 'threads': threads, 'placement': placement, 'slice_bytes': slice_bytes, 'dynamic_smem': dyn,
            'active_clusters': fused_cse.active_clusters(card, K, placement, C, threads, dyn), 'registers': regs,
            'stack': stack}  # fmt: skip


def check_rung(torch, ts, fused_cse, inputs, spec, name: str, phases: bool = False, timed: bool = True) -> dict:
    """One rung through K2 and through its plain version on the card, both
    from the same cache-less inputs: all five outputs must be equal; and the
    rung's work for its bound. With ``timed``, also K2's and the plain
    version's milliseconds (CUDA events; K2's launch alone, its wrapper's
    checks and allocations made before the span), and with ``phases`` the
    clock cycles of K2's phases from its phase-timing build."""
    dev_in = ts.rung_inputs(*inputs, spec, device='cuda')

    def fresh():  # both update the state in place
        return [t.clone() for t in dev_in]

    got = fused_cse.launch(*fresh(), spec)
    want = ts.rung_plain(*fresh(), spec)
    torch.cuda.synchronize()
    for field, g, w in zip(('E', 'qmeta', 'lat', 'records', 'cur'), got, want):
        if not torch.equal(g, w):
            bad = (g != w).nonzero()[:5].tolist()
            raise AssertionError(f'K2 rung {name}: {field} differs from the plain version at {bad}')
    rec, cur = got[3].cpu().numpy(), got[4].cpu().numpy()
    done = cur - dev_in[3].cpu().numpy()  # iterations per lane
    out = {
        'name': name, 'N': len(cur), 'P': spec.P, 'O': spec.O, 'B': spec.B, 'K': spec.topk, 'iters': int(done.sum()),
        'max_iters': int(done.max()), 'chains': sum(int((rec[n, :k, 0] == rec[n, :k, 1]).sum()) for n, k in enumerate(done)),
        'max_abs_err': max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want) if g.numel()),
    }  # fmt: skip
    if timed:
        out['ms'] = cuda_ms(fused_cse.run, reps=5, fresh=lambda: [fused_cse.prepare(*fresh(), spec)])
        out['plain_ms'] = cuda_ms(lambda *a: ts.rung_plain(*a, spec), reps=3, fresh=fresh)
        if phases:
            out['phases'] = fused_cse.phase_cycles(*fresh(), spec)
    work = rung_work(ts, inputs, rec, cur, spec)
    out['bytes_ms'] = work['bytes'] / HBM_BYTES_PER_S * 1e3
    for part in ('build', 'loop'):
        out[f'int_{part}_ms'] = work[f'int_{part}'] / INT32_OPS_PER_S * 1e3
        out[f'fp_{part}_ms'] = work[f'fp_{part}'] / FP32_OPS_PER_S * 1e3
    out['int_ms'] = out['int_build_ms'] + out['int_loop_ms']
    out['fp_ms'] = out['fp_build_ms'] + out['fp_loop_ms']
    # the int32 and fp32 pipes issue side by side: the least time is the larger
    out['ops_ms'] = max(out['int_ms'], out['fp_ms'])
    return out


def k2_empty_launch_ms(torch, ts, fused_cse, inputs, spec) -> float:
    """CUDA-event milliseconds of a K2 launch whose lanes all enter at
    cur == P, so every cluster leaves at once: the fixed cost of a launch
    (the wrapper's foreign call and the cluster launch)."""
    dev_in = ts.rung_inputs(*inputs, spec, device='cuda')
    dev_in[3].fill_(spec.P)
    return cuda_ms(fused_cse.run, reps=20, fresh=lambda: [fused_cse.prepare(*[t.clone() for t in dev_in], spec)])


def k2_launch_host_us(torch, ts, fused_cse, inputs, spec, reps: int = 100) -> float:
    """Host microseconds of one ``fused_cse.run`` call (the launch's foreign
    call), the mean of ``reps`` back-to-back calls whose lanes all enter at
    cur == P, so the card never holds the host back."""
    dev_in = ts.rung_inputs(*inputs, spec, device='cuda')
    dev_in[3].fill_(spec.P)
    prep = fused_cse.prepare(*dev_in, spec)
    fused_cse.run(prep)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fused_cse.run(prep)
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def phase_line(ph: dict) -> str:
    """K2's phase cycles (``fused_cse.phase_cycles``) as one line: the cache
    build's cycles, then each phase's cycles per iteration and its share."""
    ph = dict(ph)
    it = max(ph.pop('iterations'), 1)
    build = ph.pop('cache build')
    loop = sum(ph.values())
    parts = ', '.join(f'{k} {v / it:.0f} ({v / max(loop, 1):.1%})' for k, v in ph.items())
    return f'cache build {build} cycles; {it} iterations of {loop / it:.0f} cycles: {parts}'


# ---------------------------------------------------------------------------
# traced workloads: the config-5 model, the fusion workloads, a wide program
# ---------------------------------------------------------------------------


def config5_model(backend: str, **opts):
    """``bench.py``'s config-5 model (``_trace_model(limited=False)``) from
    the port's tracer: an 8×8×3 input, a 3×3 'same' conv to 8 channels, relu,
    a 2×2 max-pool, dense 32, relu, dense 5; weights from ``default_rng(5)``."""
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace
    from da4ml_tpu_torch.trace.ops import conv2d, max_pool2d

    rng = np.random.default_rng(5)
    side, cin, cmid, dense = 8, 3, 8, 32
    flat = (side // 2) ** 2 * cmid
    w1 = rng.integers(-32, 32, (3, 3, cin, cmid)).astype(np.float64)
    w2 = rng.integers(-32, 32, (flat, dense)).astype(np.float64)
    w3 = rng.integers(-32, 32, (dense, 5)).astype(np.float64)
    shape = (side, side, cin)
    inp = FixedVariableArrayInput(shape, hwconf=HWConfig(1, -1, -1), solver_options={'backend': backend, **opts})
    x = inp.quantize(np.ones(shape), np.full(shape, 3), np.full(shape, 2))
    x = conv2d(x, w1, padding='same')
    x = x.relu(i=np.full(x.shape, 6), f=np.full(x.shape, 2))
    x = max_pool2d(x, 2).reshape(-1)
    x = (x @ w2).relu(i=np.full(dense, 7), f=np.full(dense, 2))
    return comb_trace(inp, x @ w3)


def fusion_workloads(**opts) -> dict:
    """``bench.py``'s fusion workloads at full size (``_run_fusion_workloads
    (limited=False)``) from the port's tracer, cut into pipelines:
    ``{name: Pipeline}``; weights from ``default_rng(23)`` in bench.py's
    order. The separable conv stack is cut at latency 6, the relu-attention
    transformer block (T 8, D 8, F 16) at 8, without retiming, as there."""
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace, to_pipeline
    from da4ml_tpu_torch.trace.ops import conv2d, depthwise_conv2d, einsum, quantize, relu

    rng = np.random.default_rng(23)
    shape = (5, 5, 2)
    inp = FixedVariableArrayInput(shape, hwconf=HWConfig(1, -1, 6), solver_options=opts)
    x = inp.quantize(np.ones(shape), np.full(shape, 2), np.zeros(shape, np.int64))
    h = relu(depthwise_conv2d(x, rng.integers(-3, 4, (3, 3, 2, 1)).astype(np.float64)), i=3, f=0)
    h = relu(conv2d(h, rng.integers(-3, 4, (1, 1, 2, 3)).astype(np.float64)), i=3, f=0)
    h = relu(depthwise_conv2d(h, rng.integers(-2, 3, (2, 2, 3, 1)).astype(np.float64)), i=3, f=0)
    out = conv2d(h, rng.integers(-3, 4, (1, 1, 3, 2)).astype(np.float64))
    conv_stack = to_pipeline(comb_trace(inp, out), 6, retiming=False)

    T, D, F = 8, 8, 16
    inp = FixedVariableArrayInput((T, D), hwconf=HWConfig(1, -1, 8), solver_options=opts)
    x = inp.quantize(np.ones((T, D)), np.full((T, D), 2), np.zeros((T, D), np.int64))
    wq, wk, wv = (rng.integers(-2, 3, (D, D)).astype(np.float64) for _ in range(3))
    q = quantize(einsum('td,df->tf', x, wq), 1, 3, 0)
    k = quantize(einsum('td,df->tf', x, wk), 1, 3, 0)
    v = quantize(einsum('td,df->tf', x, wv), 1, 3, 0)
    scores = relu(einsum('td,sd->ts', q, k), i=3, f=0)  # relu-attention, no softmax
    h = quantize(x + quantize(einsum('ts,sd->td', scores, v), 1, 3, 0), 1, 3, 0)
    w1 = rng.integers(-2, 3, (D, F)).astype(np.float64)
    w2 = rng.integers(-2, 3, (F, D)).astype(np.float64)
    ffn = quantize(einsum('tf,fd->td', relu(einsum('td,df->tf', h, w1), i=3, f=0), w2), 1, 3, 0)
    block = to_pipeline(comb_trace(inp, quantize(h + ffn, 1, 3, 0)), 8, retiming=False)
    return {'conv_stack': conv_stack, 'transformer_block': block}


def wide_conv_front_end():
    """A conv front end over one 256×256 single-channel image: 3×3 kernel to
    one channel, stride 2, 'valid', then relu; weights from
    ``default_rng(256)``, solved by the native solver. 65536 inputs."""
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace
    from da4ml_tpu_torch.trace.ops import conv2d, relu

    w = np.random.default_rng(256).integers(-8, 8, (3, 3, 1, 1)).astype(np.float64)
    shape = (256, 256, 1)
    inp = FixedVariableArrayInput(shape, hwconf=HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    x = inp.quantize(np.ones(shape), np.full(shape, 3), np.full(shape, 2))
    return comb_trace(inp, relu(conv2d(x, w, strides=(2, 2), padding='valid')))


def k1_equal_plain(torch, ex, x, chunk: int, data=None, label: str = 'K1') -> float:
    """K1 (``fn_int``) against its plain version on the card, ``chunk`` rows
    at a time (the plain version's buffer is ops x rows); raises on any
    difference, with ``k1_mismatch``'s report when the float batch ``data``
    behind ``x`` is given (no retry); returns the largest absolute
    difference (0)."""
    from da4ml_tpu_torch.runtime.reference import run_program

    err = 0.0
    for r0 in range(0, x.shape[0], chunk):
        xs = x[r0 : r0 + chunk]
        got, want = ex.fn_int(xs), ex.plain(xs)
        if not torch.equal(got, want):
            report = f'{int((got != want).sum())} words differ'
            if data is not None:
                report = k1_mismatch(torch, ex, ex.prog, data[r0 : r0 + chunk], xs, got, want, run_program)
            raise AssertionError(f'{label} differs from its plain version (rows {r0}+): {report}')
        err = max(err, float((got.double() - want.double()).abs().max()))
    return err


def k1_bound_ms(ex, batch: int) -> tuple[float, str]:
    """K1's bound for ``batch`` samples of an executor's program: the larger
    of its bytes over HBM and its int32 ALU operations over the card's
    issue rate (``DaisKernel.work``)."""
    n_bytes, int_ops = ex.kernel.work(batch)
    bytes_ms, ops_ms = n_bytes / HBM_BYTES_PER_S * 1e3, int_ops / INT32_OPS_PER_S * 1e3
    return (ops_ms, 'operations') if ops_ms >= bytes_ms else (bytes_ms, 'bytes')


def rung_bound_ms(checked: list[dict]) -> float:
    """K2's bound summed over rung calls held by ``check_rung``."""
    return sum(max(r['bytes_ms'], r['ops_ms']) for r in checked)


def reference_stages(progs, data) -> list[np.ndarray]:
    """The reference interpreter's output after each of ``progs`` run in turn
    on ``data`` (a pipeline's stages, or one program). Row chunks
    (``REF_CHUNK_ROWS``) go through all the programs on a pool of one thread
    per host core: numpy releases the GIL inside each op's arrays. A chunk's
    int64 buffer is ops x rows."""
    from concurrent.futures import ThreadPoolExecutor

    from da4ml_tpu_torch.runtime.reference import run_program

    threads = os.cpu_count() or 1
    lo, hi = REF_CHUNK_ROWS
    rows = max(lo, min(hi, -(-len(data) // threads)))

    def chain(r0):
        outs, d = [], data[r0 : r0 + rows]
        for prog in progs:
            d = run_program(prog, d)
            outs.append(d)
        return outs

    with ThreadPoolExecutor(threads) as pool:
        chunks = list(pool.map(chain, range(0, len(data), rows)))
    return [np.concatenate(outs) for outs in zip(*chunks)]


def reference_equal(prog, data, y) -> None:
    """The executor's output ``y`` equals the reference interpreter's on the
    host (``reference_stages``)."""
    want = reference_stages([prog], data)[0]
    if not np.array_equal(y, want):
        bad = np.flatnonzero((y != want).any(1))
        raise AssertionError(f'K1 disagrees with the reference interpreter in {len(bad)} rows (first {bad[:10].tolist()})')


def k2_rung_ms(torch, ts, fused_cse, calls) -> float:
    """Summed CUDA-event milliseconds of K2 over recorded rung calls."""
    total = 0.0
    for inputs, spec in calls:
        dev_in = ts.rung_inputs(*inputs, spec, device='cuda')
        total += cuda_ms(fused_cse.run, reps=3, fresh=lambda: [fused_cse.prepare(*[t.clone() for t in dev_in], spec)])
    return total


def run_config5(torch, ts, fused_cse, native, card: str, ptxas) -> dict:
    """The config-5 model at full size: traced with the native solver and
    with the device search on the card (K2's count reset just before, read
    just after; no lane may go to the host and ``init_cache`` must not run),
    each byte-identical to the JAX package's trace with the same solver
    (``CONFIG5_DIGESTS``); then 2^20 numpy-seeded samples through ``DaisExecutor``
    (K1's count reset just before, read just after), equal to the plain
    version on the card (``MODEL_PLAIN_ROWS`` rows at a time) and, the first
    ``MODEL_REF_SAMPLES``, to the reference interpreter on the host. Returns
    the main-path launches of K1 and K2."""
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    t0 = time.perf_counter()
    comb_cpp = config5_model('cpp')
    cpp_s = time.perf_counter() - t0
    pmax0 = ts.search_stats['pmax_host_fallbacks']
    clock, clock_s = host_clock(ts, native)
    with RungRecorder(ts, fused_cse) as rungs, clock:
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        comb_dev = config5_model('torch')
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        k2_launches = fused_cse.launches
    pmax_routes = ts.search_stats['pmax_host_fallbacks'] - pmax0
    assert k2_launches == len(rungs.calls) > 0, 'config 5: K2 must launch once per rung call'
    assert rungs.init_cache_calls == 0, 'config 5: the device search built a score cache outside K2'
    assert pmax_routes == 0, f'config 5: {pmax_routes} lanes went to the host solver'
    digests = {k: hashlib.sha256(c.to_binary().astype('<i4').tobytes()).hexdigest()
               for k, c in (('cpp', comb_cpp), ('torch', comb_dev))}  # fmt: skip
    assert digests['cpp'] == CONFIG5_DIGESTS['cpp'], f"config 5: the 'cpp' trace differs from the reference's: {digests}"
    assert digests['torch'] == CONFIG5_DIGESTS['jax'], f"config 5: the 'torch' trace differs from the reference's: {digests}"
    checked = [check_rung(torch, ts, fused_cse, inp, spec, f'config 5 {k}', timed=False)
               for k, (inp, spec) in enumerate(rungs.calls)]  # fmt: skip
    k2_ms = k2_rung_ms(torch, ts, fused_cse, rungs.calls)
    print(f"config 5 (8x8x3 conv, max-pool, dense 32, dense 5): 'cpp' trace {cpp_s:.3f} s ({len(comb_cpp.ops)} ops, "
          f"cost {comb_cpp.cost}); 'torch' trace {dev_s:.3f} s on the card, of which solve {clock_s['solve']:.3f} s "
          f"(tracing {dev_s - clock_s['solve']:.3f} s); {len(rungs.calls)} rung calls, K2 launched {k2_launches} times, "
          f"{k2_ms:.4f} ms on the card, bound {rung_bound_ms(checked):.6f} ms, each rung call "
          f"({sum(r['iters'] for r in checked)} iterations) equal to its plain version on the card; no init_cache "
          f"call, no host lane; {len(comb_dev.ops)} ops, cost {comb_dev.cost}; "
          f"each program byte-identical to the JAX package's trace with the same solver ('cpp'; 'jax' for 'torch')",
          flush=True)  # fmt: skip

    prog = decode(comb_dev.to_binary())
    data = np.random.default_rng(20261018).uniform(-8, 8, (MODEL_SAMPLES, prog.n_in))
    ex = DaisExecutor(prog)
    cuda_backend.reset_counts()
    y = ex(data)
    torch.cuda.synchronize()
    launches = cuda_backend.launches
    assert launches > 0 and y.shape == (MODEL_SAMPLES, prog.n_out) and np.isfinite(y).all()
    x = ex.int_inputs(data)
    err = k1_equal_plain(torch, ex, x, MODEL_PLAIN_ROWS)
    reference_equal(prog, data[:MODEL_REF_SAMPLES], y[:MODEL_REF_SAMPLES])
    call_vs_one_launch(torch, ex, data, y, 'config 5', card)
    # the two solvers' programs compute the same function
    reference_equal(decode(comb_cpp.to_binary()), data[:MODEL_REF_SAMPLES], y[:MODEL_REF_SAMPLES])
    line, _ = k1_shape(torch, ex, ptxas)
    ms = cuda_ms(lambda: ex.fn_int(x), reps=10)
    plain_ms = cuda_ms(lambda: ex.plain(x[:MODEL_PLAIN_ROWS]), reps=3)
    bound_ms, _ = k1_bound_ms(ex, MODEL_SAMPLES)
    print(f'[{card}] config 5 dais_exec: {line}')
    print(f'[{card}] config 5: K1 {ms:.4f} ms for {MODEL_SAMPLES} samples ({launches} launches on the main path), '
          f'plain version {plain_ms:.4f} ms for {MODEL_PLAIN_ROWS}; bound {bound_ms:.4f} ms; all samples equal to the '
          f"plain version (max abs err {err}), the first {MODEL_REF_SAMPLES} to the reference interpreter on this "
          f"program and on the 'cpp' one", flush=True)  # fmt: skip
    return {'k1_launches': launches, 'k2_launches': k2_launches, 'k2_err': max(r['max_abs_err'] for r in checked),
            'cost': float(comb_dev.cost), 'prog': prog, 'ref_y': y[:MODEL_REF_SAMPLES], 'binary': comb_dev.to_binary()}  # fmt: skip


def stages_digest(pipe) -> str:
    """sha256 of a pipeline's stages: their DAIS binaries (little-endian
    int32), one after another."""
    h = hashlib.sha256()
    for stage in pipe.stages:
        h.update(stage.to_binary().astype('<i4').tobytes())
    return h.hexdigest()


def run_fusion(torch, ts, fused_cse, card: str, ptxas) -> dict:
    """The fusion workloads at full size, solved by the device search on the
    card (K2's count reset just before, read just after; no lane may go to
    the host and ``init_cache`` must not run) and by the native solver: the
    two pipelines' stages byte-identical and equal to the JAX package's
    (``FUSION_DIGESTS``), every rung call through K2 equal to its plain
    version on the card; then ``FUSION_SAMPLES`` samples through
    ``Pipeline.predict(backend='torch')``, one K1 launch a stage (K1's count
    reset just before, read just after), equal to the stage-by-stage
    reference interpreter and each stage to its plain version on the card;
    then each workload through the four pipeline modes (``pipeline_modes``)
    and its fused program (``fusion_fused``). Returns the main-path launches
    and K2's largest difference."""
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.reference import run_program
    from da4ml_tpu_torch.runtime.torch_backend import executor_for_binary

    pmax0 = ts.search_stats['pmax_host_fallbacks']
    with RungRecorder(ts, fused_cse) as rungs:
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        pipes = fusion_workloads(backend='torch')
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        k2_launches = fused_cse.launches
    pmax_routes = ts.search_stats['pmax_host_fallbacks'] - pmax0
    assert k2_launches == len(rungs.calls) > 0, 'fusion: K2 must launch once per rung call'
    assert rungs.init_cache_calls == 0, 'fusion: the device search built a score cache outside K2'
    assert pmax_routes == 0, f'fusion: {pmax_routes} lanes went to the host solver'
    host = fusion_workloads(backend='cpp')
    for name, pipe in pipes.items():
        digest = stages_digest(pipe)
        assert digest == stages_digest(host[name]), f"fusion {name}: the 'torch' and 'cpp' stages differ"
        assert digest == FUSION_DIGESTS[name], f"fusion {name}: the stages differ from the reference's ({digest})"
    checked = [check_rung(torch, ts, fused_cse, inp, spec, f'fusion {k}', timed=False)
               for k, (inp, spec) in enumerate(rungs.calls)]  # fmt: skip
    k2_ms = k2_rung_ms(torch, ts, fused_cse, rungs.calls)
    print(f"fusion workloads: traced and solved on the card in {dev_s:.3f} s, K2 launched {k2_launches} times, "
          f"{k2_ms:.4f} ms on the card, bound {rung_bound_ms(checked):.6f} ms, each rung call "
          f"({sum(r['iters'] for r in checked)} iterations) equal to its plain version on the card; no init_cache "
          f"call, no host lane; stages byte-identical to the 'cpp' trace's "
          f"and the JAX package's", flush=True)  # fmt: skip
    k1_launches, modes = 0, {}
    rng = np.random.default_rng(20261019)
    for name, pipe in pipes.items():
        data = rng.uniform(-4, 4, (FUSION_SAMPLES, pipe.shape[0]))
        cuda_backend.reset_counts()
        y = pipe.predict(data, backend='torch')
        torch.cuda.synchronize()
        launches = cuda_backend.launches
        k1_launches += launches
        assert launches >= len(pipe.stages), f'{name}: {launches} K1 launches for {len(pipe.stages)} stages'
        want, per_stage = data, []
        for stage in pipe.stages:
            binary = stage.to_binary()
            ex = executor_for_binary(binary)
            x = ex.int_inputs(want)
            k1_equal_plain(torch, ex, x, FUSION_SAMPLES)
            per_stage.append((len(stage.ops), cuda_ms(lambda: ex.fn_int(x), reps=10), k1_bound_ms(ex, FUSION_SAMPLES)[0]))
            want = run_program(decode(binary), want)
        assert np.array_equal(y, want), f'{name}: the staged K1 run disagrees with the reference interpreter'
        stages = ', '.join(f'{n} ops {ms:.4f} ms (bound {b:.4f} ms)' for n, ms, b in per_stage)
        print(f'[{card}] fusion {name}: {len(pipe.stages)} stages, {launches} K1 launches for {FUSION_SAMPLES} '
              f'samples; per stage {stages}; equal to the plain version and the stage-by-stage reference',
              flush=True)  # fmt: skip
        for mode, n in pipeline_modes(torch, pipe, data, f'fusion {name}', card).items():
            modes[mode] = modes.get(mode, 0) + n
        fusion_fused(torch, name, pipe, data, card, ptxas)
    return {'k1_launches': k1_launches, 'k1_modes': modes, 'k2_launches': k2_launches,
            'k2_err': max(r['max_abs_err'] for r in checked), 'pipes': pipes}  # fmt: skip


def run_wide_conv(torch, card: str, ptxas) -> dict:
    """The 256×256 conv front end (65536 inputs), traced with the native
    solver, through K1's 24-bit-field route on ``WIDE_CONV_SAMPLES`` samples
    (K1's count reset just before, read just after), equal to the plain
    version on the card and the reference interpreter."""
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    t0 = time.perf_counter()
    comb = wide_conv_front_end()
    trace_s = time.perf_counter() - t0
    prog = decode(comb.to_binary())
    data = np.random.default_rng(20261020).uniform(-8, 8, (WIDE_CONV_SAMPLES, prog.n_in))
    ex = DaisExecutor(prog)
    cuda_backend.reset_counts()
    y = ex(data)
    torch.cuda.synchronize()
    launches, scratch_launches = cuda_backend.launches, cuda_backend.scratch_launches
    assert launches > 0 and ex.kernel.data.field_bits == 24, (launches, ex.kernel.data.field_bits)
    x = ex.int_inputs(data)
    err = k1_equal_plain(torch, ex, x, WIDE_CONV_SAMPLES)
    reference_equal(prog, data, y)
    call_vs_one_launch(torch, ex, data, y, 'wide conv', card)
    line, _ = k1_shape(torch, ex, ptxas)
    ms = cuda_ms(lambda: ex.fn_int(x), reps=5)
    plain_ms = cuda_ms(lambda: ex.plain(x), reps=3)
    bound_ms, _ = k1_bound_ms(ex, WIDE_CONV_SAMPLES)
    print(f"wide conv front end (256x256x1, 3x3 stride 2 'valid', relu; 'cpp'): traced in {trace_s:.3f} s (host "
          f"clock), {prog.n_ops} ops, {prog.n_in} inputs, {prog.n_out} outputs", flush=True)  # fmt: skip
    print(f'[{card}] wide conv dais_exec: {line}')
    print(f'[{card}] wide conv: K1 {ms:.4f} ms for {WIDE_CONV_SAMPLES} samples ({launches} launches on the main path, '
          f'{scratch_launches} scratch), plain version {plain_ms:.4f} ms; bound {bound_ms:.4f} ms; equal '
          f'to the plain version (max abs err {err}) and the reference interpreter', flush=True)  # fmt: skip
    return {'k1_launches': launches, 'prog': prog, 'y': y}


# ---------------------------------------------------------------------------
# the call boundary, pipelines and IR fusion
# ---------------------------------------------------------------------------


def one_launch_route(torch, ex, data) -> np.ndarray:
    """The one-launch route through an executor: the host's ``_int_inputs``, one
    upload, one ``fn_int`` over the whole batch, ``.cpu()``, the host's
    int->float."""
    y = ex.fn_int(ex.int_inputs(data)).cpu().numpy()
    return y.astype(np.float64) * ex._out_scale()


def call_vs_one_launch(torch, ex, data, y, label: str, card: str) -> None:
    """A warm ``DaisExecutor.__call__`` (chunked, converted on the card)
    against the one-launch route on the same batch: equal to ``y`` both;
    prints both host times and the call's K1 launches."""
    from da4ml_tpu_torch.runtime import cuda_backend

    cuda_backend.reset_counts()
    t0 = time.perf_counter()
    again = ex(data)
    call_s = time.perf_counter() - t0
    launches = cuda_backend.launches
    t0 = time.perf_counter()
    old = one_launch_route(torch, ex, data)
    old_s = time.perf_counter() - t0
    assert np.array_equal(again, y) and np.array_equal(old, y), f'{label}: the call and the one-launch route differ'
    print(f'[{card}] {label} call: {call_s:.4f} s ({launches} K1 launches), the one-launch route {old_s:.4f} s (host '
          f'clock); equal', flush=True)  # fmt: skip


def host_conversion_parts(ex, data) -> dict[str, float]:
    """Host seconds of ``_int_inputs``' four parts on ``data``, apart:
    ``validate_batch``'s finite check, the scale, ``np.floor``, the cast."""
    arr = np.asarray(data, dtype=np.float64)
    t0 = time.perf_counter()
    finite = bool(np.isfinite(arr).all())
    t1 = time.perf_counter()
    scaled = arr * ex._in_scale
    t2 = time.perf_counter()
    floored = np.floor(scaled)
    t3 = time.perf_counter()
    x = floored.astype(ex.np_dtype)
    t4 = time.perf_counter()
    assert finite and np.array_equal(x, ex._int_inputs(data))
    return {'finite check': t1 - t0, 'scale': t2 - t1, 'floor': t3 - t2, 'cast': t4 - t3}


def call_stages(torch, ex, data) -> tuple[int, dict[str, float]]:
    """``DaisExecutor.__call__``'s route by stage, each timed alone with CUDA
    events over the whole batch (the flagship's is one chunk): the upload from
    the caller's pageable array, the conversion on the card, K1, the
    int->float on the card and the download into pageable memory. Returns the
    chunk count and each stage's milliseconds."""
    from da4ml_tpu_torch.runtime.torch_backend import _infer_chunks

    card = torch.device('cuda', 0)
    host = torch.from_numpy(np.ascontiguousarray(data))
    xf = torch.empty(host.shape, dtype=torch.float64, device=card)
    bad = torch.zeros((), dtype=torch.int64, device=card)
    ms = {'upload': cuda_ms(lambda: xf.copy_(host), reps=10)}
    ms['conversion on the card'] = cuda_ms(lambda: ex.int_inputs_on(xf, bad), reps=10)
    xi = ex.int_inputs_on(xf, bad)
    ms['K1'] = cuda_ms(lambda: ex.fn_int(xi), reps=10)
    yi = ex.fn_int(xi)
    ms['int->float on the card'] = cuda_ms(lambda: ex.float_outputs_on(yi), reps=10)
    yf = ex.float_outputs_on(yi)
    ms['download'] = cuda_ms(lambda: yf.cpu(), reps=10)
    assert int(bad) == 0
    return _infer_chunks(len(data), 8 * data.shape[1]), ms


def repeated_calls(ex, data, want, label: str) -> list[float]:
    """``BOUNDARY_REPEATS`` calls of ``ex`` on ``data``, each equal to
    ``want``; returns their host seconds."""
    call_s = []
    for k in range(BOUNDARY_REPEATS):
        t0 = time.perf_counter()
        again = ex(data)
        call_s.append(time.perf_counter() - t0)
        assert np.array_equal(again, want), f'flagship: call {k} ({label}) differs from the one-launch route'
    return call_s


def run_boundary(torch, ex, data, y, card: str) -> None:
    """The flagship behind ``DaisExecutor.__call__``'s boundary: its output
    ``y`` equals the one-launch route, and ``BOUNDARY_REPEATS`` more calls
    each equal it, at the port's chunk rule (one chunk here) and at the
    reference's (1 MiB a chunk, at most 16: the staged path, its pinned
    buffers, streams and events); prints the calls' times, the route by stage
    and the host conversion's four parts."""
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime import torch_backend as tb

    want = one_launch_route(torch, ex, data)
    assert np.array_equal(y, want), 'flagship: the call differs from the one-launch route'
    kept_s = repeated_calls(ex, data, want, 'the chunk rule')
    with Patched({(tb, 'CHUNK_BYTES'): lambda _: 1 << 20, (tb, 'CHUNK_MAX'): lambda _: 16}):
        cuda_backend.reset_counts()
        staged_s = repeated_calls(ex, data, want, "the reference's chunk rule")
        staged_launches = cuda_backend.launches
    t0 = time.perf_counter()
    one_launch_route(torch, ex, data)
    old_s = time.perf_counter() - t0
    nc, ms = call_stages(torch, ex, data)
    parts = host_conversion_parts(ex, data)

    def fmt(d, unit, k=1.0):
        return ', '.join(f'{name} {v * k:.4f} {unit}' for name, v in d.items())

    def spread(xs):
        return f'median {statistics.median(xs):.4f} s (min {min(xs):.4f}, max {max(xs):.4f})'

    print(f'[{card}] flagship call boundary, {len(data)} samples, {BOUNDARY_REPEATS} calls each equal to the one-launch '
          f"route (host clock): the port's chunk rule ({nc} chunk) {spread(kept_s)}; the reference's (16 chunks "
          f'through pinned staging, {staged_launches} K1 launches) {spread(staged_s)}; the one-launch route (host '
          f'conversion, one upload, one launch, .cpu()) {old_s:.4f} s', flush=True)  # fmt: skip
    print(f'[{card}] flagship call by stage, each timed alone: {fmt(ms, "ms")}')
    print(f'flagship host float->int, apart (host clock, {cpu_model()}): {fmt(parts, "s")}; total '
          f'{sum(parts.values()):.4f} s')  # fmt: skip


def conversion_edges(torch, ex32, ex64) -> None:
    """The conversion on the card on values beyond each integer type's range
    (``OUT_OF_RANGE``): word for word equal to the host's ``_int_inputs``, as
    is the whole call to the one-launch route; a NaN and an inf are
    refused with the host's error text."""
    from da4ml_tpu_torch.runtime.torch_backend import InvalidInputError, validate_batch

    card = torch.device('cuda', 0)
    for ex in (ex32, ex64):
        bits = 8 * np.dtype(ex.np_dtype).itemsize
        vals = np.array(OUT_OF_RANGE[bits])
        rng = np.random.default_rng(bits)
        batch = rng.uniform(-8, 8, (64, ex.prog.n_in))
        rows = rng.integers(0, len(batch), 4 * len(vals))
        batch[rows, rng.integers(0, ex.prog.n_in, len(rows))] = np.resize(vals, len(rows))
        bad = torch.zeros((), dtype=torch.int64, device=card)
        got = ex.int_inputs_on(torch.from_numpy(batch).to(card), bad).cpu().numpy()
        with np.errstate(invalid='ignore'):  # numpy warns on the out-of-range cast it makes
            want = ex._int_inputs(batch)
            old = one_launch_route(torch, ex, batch)
        assert int(bad) == 0 and got.dtype == want.dtype and np.array_equal(got, want), (
            f'int{bits}: the conversion on the card differs from the host in {int((got != want).sum())} words')
        assert np.array_equal(ex(batch), old), f'int{bits}: the call differs from the one-launch route'
        for v in (np.nan, np.inf, -np.inf):
            odd = batch.copy()
            odd[3, 0] = v
            try:
                validate_batch(odd, ex.prog.n_in)
            except InvalidInputError as e:
                host_msg = str(e)
            try:
                ex(odd)
            except InvalidInputError as e:
                assert str(e) == host_msg, (str(e), host_msg)
            else:
                raise AssertionError(f'int{bits}: {v} was not refused')
        print(f'conversion on the card, int{bits}: {len(rows)} values in {sorted(set(vals.tolist()))} equal to the '
              f"host's cast word for word; NaN, inf and -inf refused with the host's error", flush=True)  # fmt: skip


def pipeline_model():
    """``bench.py``'s pipeline model (``_run_inference_micro(limited=False)``)
    from the port's tracer: 16 inputs (1, 3, 2), dense 64, relu (6, 2), dense
    8, weights from ``default_rng(11)``, then its 262144 samples from the same
    generator; cut by ``to_pipeline(comb, 3.0)``. Returns the pipeline and
    the samples."""
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace, to_pipeline

    rng = np.random.default_rng(11)
    n_in, hidden = 16, 64
    inp = FixedVariableArrayInput(n_in, hwconf=HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    x = inp.quantize(np.ones(n_in), np.full(n_in, 3), np.full(n_in, 2))
    w1 = rng.integers(-8, 8, (n_in, hidden)).astype(np.float64)
    x = (x @ w1).relu(i=np.full(hidden, 6), f=np.full(hidden, 2))
    w2 = rng.integers(-8, 8, (hidden, 8)).astype(np.float64)
    comb = comb_trace(inp, x @ w2)
    data = rng.uniform(-8, 8, (PIPELINE_SAMPLES, n_in))
    return to_pipeline(comb, 3.0), data


def pipeline_modes(torch, pipe, data, label: str, card: str) -> dict[str, int]:
    """A pipeline through ``Pipeline.predict(backend='torch')`` with
    ``fused=True``, ``False`` and ``'ir'`` and through the per-stage host
    loop (``run_binary`` a stage, the float boundary between stages), each
    after a warm call, K1's count reset just before and read just after the
    timed call: each equal to ``predict(backend='numpy')``. Prints the
    samples/s (host clock) and K1 launches of each; returns the launches."""
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import run_binary

    golden = pipe.predict(data, backend='numpy')
    binaries = [s.to_binary() for s in pipe.stages]

    def hostloop(d):
        for b in binaries:
            d = run_binary(b, d)
        return d

    modes = {'fused': lambda: pipe.predict(data, backend='torch', fused=True),
             'chained': lambda: pipe.predict(data, backend='torch', fused=False),
             'ir': lambda: pipe.predict(data, backend='torch', fused='ir'),
             'hostloop': lambda: hostloop(data)}  # fmt: skip
    launches, lines = {}, []
    for mode, run in modes.items():
        run()
        torch.cuda.synchronize()
        cuda_backend.reset_counts()
        t0 = time.perf_counter()
        y = run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[mode] = cuda_backend.launches
        assert launches[mode] > 0, f'{label} {mode}: K1 was not launched'
        assert np.array_equal(y, golden), f"{label} {mode}: differs from predict(backend='numpy')"
        lines.append(f'{mode} {len(data) / dt:.6g} samples/s ({launches[mode]} K1 launches)')
    print(f"[{card}] {label}, {len(pipe.stages)} stages, {len(data)} samples, each equal to predict(backend='numpy'): "
          f"{'; '.join(lines)}", flush=True)  # fmt: skip
    return launches


def stages_equal_plain(torch, pipe, data, label: str) -> None:
    """Each stage's K1 against its plain version on the card, on the stage's
    inputs from the staged reference."""
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime.reference import run_program
    from da4ml_tpu_torch.runtime.torch_backend import executor_for_binary

    want = data
    for k, stage in enumerate(pipe.stages):
        binary = stage.to_binary()
        ex = executor_for_binary(binary)
        k1_equal_plain(torch, ex, ex.int_inputs(want), 1 << 16)
        want = run_program(decode(binary), want)
    print(f"{label}: each of the {len(pipe.stages)} stages' K1 equal to its plain version on the card", flush=True)


def run_pipeline_model(torch, card: str) -> dict[str, int]:
    """``bench.py``'s pipeline model through the four modes, each stage's K1
    and the fused program's held to their plain versions on the card."""
    from da4ml_tpu_torch.runtime.torch_backend import fused_executor_for_binaries

    pipe, data = pipeline_model()
    launches = pipeline_modes(torch, pipe, data, 'pipeline model', card)
    stages_equal_plain(torch, pipe, data, 'pipeline model')
    ex = fused_executor_for_binaries([s.to_binary() for s in pipe.stages])
    k1_equal_plain(torch, ex, ex.int_inputs(data), 1 << 16)
    return launches


def fusion_fused(torch, name: str, pipe, data, card: str, ptxas) -> None:
    """A fusion workload's fused program: ``fuse_binaries`` equal to the JAX
    package's (``FUSED_DIGESTS``), its ``FusionReport``, its launch shape, K1
    against its plain version, and ``FUSED_REPEATS`` launches on the same
    inputs, none differing."""
    from da4ml_tpu_torch.ir.fuse import fuse_binaries
    from da4ml_tpu_torch.runtime.torch_backend import fused_executor_for_binaries

    binaries = [s.to_binary() for s in pipe.stages]
    digest = hashlib.sha256(fuse_binaries(binaries).astype('<i4').tobytes()).hexdigest()
    assert digest == FUSED_DIGESTS[name], f"fusion {name}: the fused program differs from the reference's ({digest})"
    _, rep = pipe.fuse(report=True)
    ex = fused_executor_for_binaries(binaries)
    x = ex.int_inputs(data)
    k1_equal_plain(torch, ex, x, len(data))
    first = ex.kernel.launch(x)
    differ = 0
    for _ in range(FUSED_REPEATS):
        differ += not torch.equal(ex.kernel.launch(x), first)
    torch.cuda.synchronize()
    assert differ == 0, f'fusion {name}: {differ} of {FUSED_REPEATS} launches of the fused program differ'
    line, _ = k1_shape(torch, ex, ptxas)
    ms = cuda_ms(lambda: ex.fn_int(x), reps=10)
    bound_ms, bound_by = k1_bound_ms(ex, len(data))
    print(f"fusion {name} fused: {rep}; byte-identical to the JAX package's fused program", flush=True)
    print(f'[{card}] fusion {name} fused dais_exec: {line}; K1 {ms:.4f} ms for {len(data)} samples, bound '
          f'{bound_ms:.4f} ms by {bound_by}, equal to the plain version; {FUSED_REPEATS} launches on the same inputs, '
          f'none differing', flush=True)  # fmt: skip


# ---------------------------------------------------------------------------
# the firmware path: codegen, its precondition, the PyTorch front end
# ---------------------------------------------------------------------------


def corrupted_mul_program():
    """A program the codegen precondition must refuse: a product of two
    traced inputs (``mul``) whose annotation is narrowed 64-fold, the port's
    counterpart of the reference's ``mul.narrowed_interval`` corruption."""
    from da4ml_tpu_torch.ir import QInterval
    from da4ml_tpu_torch.trace import FixedVariableArrayInput, HWConfig, comb_trace

    inp = FixedVariableArrayInput(4, hwconf=HWConfig(1, -1, -1), solver_options={'backend': 'cpp'})
    x = inp.quantize(np.ones(4), np.full(4, 3), np.full(4, 2))
    comb = comb_trace(inp, x[:2] * x[2:])
    ops = list(comb.ops)
    k = next(i for i, op in enumerate(ops) if op.opcode == 7)
    q = ops[k].qint
    ops[k] = ops[k]._replace(qint=QInterval(q.min / 64.0, q.max / 64.0, q.step))
    return comb._replace(ops=ops)


def firmware_flagship(torch, comb, tmp, card: str) -> dict:
    """The flagship program written as Verilog and VHDL projects at latency
    ``FIRMWARE_CUTOFF`` (``PROJECT_DIGESTS``); ``predict(backend='interp')``
    on ``FIRMWARE_SAMPLES`` samples through K1 (its count reset just before,
    read just after), equal to the stage-by-stage reference interpreter and
    each stage's K1 to its plain version; ``predict(backend='netlist')`` of
    both projects on the first ``FLAGSHIP_NETLIST_SAMPLES``, equal to K1's
    rows. Prints the phase's wall time by step."""
    from da4ml_tpu_torch.codegen import VerilogModel, VHDLModel
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import executor_for_binary

    laps = Laps()
    models, write_s, files = {}, {}, {}
    for flavor, cls in (('verilog', VerilogModel), ('vhdl', VHDLModel)):
        t0 = time.perf_counter()
        models[flavor] = cls(comb, 'model', tmp / flavor, latency_cutoff=FIRMWARE_CUTOFF).write()
        write_s[flavor] = time.perf_counter() - t0
        files[flavor] = sum(1 for p in (tmp / flavor).rglob('*') if p.is_file())
        digest = project_digest(tmp / flavor)
        assert digest == PROJECT_DIGESTS[flavor], f"firmware: the flagship's {flavor} project differs ({digest})"
    laps.lap('write')
    rtl = models['verilog']
    pipe = rtl.solution
    assert rtl.is_pipeline and rtl.register_layers == 1
    data = np.random.default_rng(20261021).uniform(-8, 8, (FIRMWARE_SAMPLES, comb.shape[0]))
    cuda_backend.reset_counts()
    t0 = time.perf_counter()
    y = rtl.predict(data, backend='interp')
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = cuda_backend.launches
    assert launches >= len(pipe.stages), f'firmware: {launches} K1 launches for {len(pipe.stages)} stages'
    assert y.shape == (FIRMWARE_SAMPLES, comb.shape[1]) and np.isfinite(y).all()
    t0 = time.perf_counter()
    assert np.array_equal(rtl.predict(data, backend='interp'), y), 'firmware flagship: a second call differs'
    warm_s = time.perf_counter() - t0
    laps.lap('predict')
    net_s = {}
    for flavor, model in models.items():
        t0 = time.perf_counter()
        yn = model.predict(data[:FLAGSHIP_NETLIST_SAMPLES], backend='netlist')
        net_s[flavor] = time.perf_counter() - t0
        assert np.array_equal(yn, y[:FLAGSHIP_NETLIST_SAMPLES]), f'firmware flagship: the {flavor} netlist differs from K1'
    laps.lap('netlist')
    binaries = [stage.to_binary() for stage in pipe.stages]
    stage_out = reference_stages([decode(b) for b in binaries], data)
    if not np.array_equal(y, stage_out[-1]):
        bad = np.flatnonzero((y != stage_out[-1]).any(1))
        raise AssertionError(f'firmware flagship: K1 differs from the reference interpreter in {len(bad)} rows '
                             f'(first {bad[:10].tolist()})')  # fmt: skip
    laps.lap('reference interpreter')
    stage_ms, bound_ms, err = [], 0.0, 0.0
    for k, (binary, want) in enumerate(zip(binaries, [data, *stage_out[:-1]])):
        ex = executor_for_binary(binary)
        x = ex.int_inputs(want)
        err = max(err, k1_equal_plain(torch, ex, x, 1 << 18, want, f'firmware flagship stage {k}'))
        stage_ms.append(cuda_ms(lambda: ex.fn_int(x), reps=10))
        bound_ms += k1_bound_ms(ex, FIRMWARE_SAMPLES)[0]
    laps.lap('K1 against its plain version, timed')
    print(f"[{card}] firmware flagship (latency cutoff {FIRMWARE_CUTOFF}: {len(pipe.stages)} stages, "
          f"{sum(len(s.ops) for s in pipe.stages)} ops): Verilog written in {write_s['verilog']:.3f} s "
          f"({files['verilog']} files), VHDL in {write_s['vhdl']:.3f} s ({files['vhdl']} files), each project equal "
          f"to the JAX package's; predict(backend='interp') on {FIRMWARE_SAMPLES} samples {call_s:.4f} s the first "
          f"call, {warm_s:.4f} s the second (host clock), {launches} K1 launches, K1 {sum(stage_ms):.4f} ms over the stages "
          f"({', '.join(f'{ms:.4f}' for ms in stage_ms)}), bound {bound_ms:.4f} ms; equal to the stage-by-stage "
          f"reference interpreter and each stage to its plain version (max abs err {err}); netlist on "
          f"{FLAGSHIP_NETLIST_SAMPLES} samples equal to K1's rows: Verilog {net_s['verilog']:.3f} s, VHDL "
          f"{net_s['vhdl']:.3f} s (host clock, {cpu_model()})", flush=True)  # fmt: skip
    print(f'firmware flagship wall time by step (host clock, {cpu_model()}): {laps.line()}', flush=True)
    return {'k1_launches': launches, 'k1_ms': sum(stage_ms), 'k1_bound_ms': bound_ms, 'k1_err': err}


def firmware_twin(torch, ts, fused_cse, tmp, card: str) -> dict:
    """The config-5 twin (``models.config5_twin``, full width) through the
    PyTorch front end: ``trace_model`` with ``'cpp'`` and with ``'torch'``
    on the card (K2's count reset just before, read just after; no lane to the
    host, no ``init_cache`` call; every rung call equal to K2's plain
    version), each program equal to the JAX package's trace with the same
    solver (``TWIN_DIGESTS``); ``predict`` on ``FIRMWARE_SAMPLES`` samples
    of the input grid through K1 (count reset just before, read just after),
    equal to its plain version on the card and to the native host
    interpreter on every sample, and to the reference interpreter, the
    module's own float64 forward and the ``'cpp'`` program on the first
    ``TWIN_FORWARD_SAMPLES``; its Verilog project at latency
    ``FIRMWARE_CUTOFF`` (``PROJECT_DIGESTS['twin_verilog']``) and the netlist
    on ``TWIN_NETLIST_SAMPLES`` samples, equal to K1's rows.

    The native interpreter runs on a host thread (its OpenMP team on all
    cores but one) while the rung checks, K1's check against its plain
    version and the reference checks run; what is timed runs before it starts
    or after it ends. Prints the phase's wall time by step."""
    from concurrent.futures import ThreadPoolExecutor

    from da4ml_tpu_torch import native
    from da4ml_tpu_torch.codegen import VerilogModel
    from da4ml_tpu_torch.converter import trace_model
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.models import CONFIG5_INPUTS_KIF, config5_twin
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor
    from da4ml_tpu_torch.trace import HWConfig, comb_trace

    model = config5_twin()
    laps = Laps()

    def trace(opts):
        return comb_trace(*trace_model(model, HWConfig(1, -1, -1), opts, inputs_kif=CONFIG5_INPUTS_KIF))

    t0 = time.perf_counter()
    comb_cpp = trace({'backend': 'cpp'})
    cpp_s = time.perf_counter() - t0
    laps.lap("trace 'cpp'")
    pmax0 = ts.search_stats['pmax_host_fallbacks']
    with RungRecorder(ts, fused_cse) as rungs:
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        comb = trace({'backend': 'torch'})
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        k2_launches = fused_cse.launches
    pmax_routes = ts.search_stats['pmax_host_fallbacks'] - pmax0
    assert k2_launches == len(rungs.calls) > 0, 'twin: K2 must launch once per rung call'
    assert rungs.init_cache_calls == 0, 'twin: the device search built a score cache outside K2'
    assert pmax_routes == 0, f'twin: {pmax_routes} lanes went to the host solver'
    digests = {k: hashlib.sha256(c.to_binary().astype('<i4').tobytes()).hexdigest()
               for k, c in (('cpp', comb_cpp), ('jax', comb))}  # fmt: skip
    assert digests == TWIN_DIGESTS, f"twin: the traces differ from the JAX package's with the same solver: {digests}"
    laps.lap("trace 'torch'")
    k2_ms = k2_rung_ms(torch, ts, fused_cse, rungs.calls)
    laps.lap('K2 timed')

    binary = comb.to_binary()
    prog = decode(binary)
    rng = np.random.default_rng(20261022)
    data = np.floor(rng.uniform(-8, 8, (FIRMWARE_SAMPLES, prog.n_in)) * 4) / 4
    cuda_backend.reset_counts()
    t0 = time.perf_counter()
    y = comb.predict(data)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = cuda_backend.launches
    assert launches > 0 and y.shape == (FIRMWARE_SAMPLES, prog.n_out) and np.isfinite(y).all()
    t0 = time.perf_counter()
    assert np.array_equal(comb.predict(data), y), 'twin: a second call differs'
    warm_s = time.perf_counter() - t0
    laps.lap('predict')
    ex = DaisExecutor(prog)
    x = ex.int_inputs(data)
    ms = cuda_ms(lambda: ex.fn_int(x), reps=5)
    bound_ms, bound_by = k1_bound_ms(ex, FIRMWARE_SAMPLES)
    laps.lap('K1 timed')

    native_threads = max(1, (os.cpu_count() or 1) - 1)

    def native_run():
        t0 = time.perf_counter()
        out = native.run_binary(binary, data, n_threads=native_threads)
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(1) as host:
        native_job = host.submit(native_run)
        checked = [check_rung(torch, ts, fused_cse, inp, spec, f'twin {k}', timed=False)
                   for k, (inp, spec) in enumerate(rungs.calls)]  # fmt: skip
        k2_bound = rung_bound_ms(checked)
        laps.lap('rung checks and bounds')
        err = k1_equal_plain(torch, ex, x, MODEL_PLAIN_ROWS, data, 'twin')
        laps.lap('K1 against its plain version')
        reference_equal(prog, data[:TWIN_FORWARD_SAMPLES], y[:TWIN_FORWARD_SAMPLES])
        x_fwd = torch.from_numpy(data[:TWIN_FORWARD_SAMPLES].reshape(-1, *model.input_shape))
        with torch.no_grad():
            fwd = torch.func.vmap(model)(x_fwd).numpy()
        assert np.array_equal(y[:TWIN_FORWARD_SAMPLES], fwd), "twin: K1 differs from the module's float64 forward"
        # the 'cpp' trace computes the same function
        reference_equal(decode(comb_cpp.to_binary()), data[:TWIN_FORWARD_SAMPLES], y[:TWIN_FORWARD_SAMPLES])
        laps.lap('reference interpreter and forward')
        y_native, native_s = native_job.result()
        laps.lap('native interpreter, after the checks')
    assert np.array_equal(y, y_native), 'twin: K1 differs from the native host interpreter'

    t0 = time.perf_counter()
    rtl = VerilogModel(comb, 'model', tmp / 'twin', latency_cutoff=FIRMWARE_CUTOFF).write()
    write_s = time.perf_counter() - t0
    n_files = sum(1 for p in (tmp / 'twin').rglob('*') if p.is_file())
    digest = project_digest(tmp / 'twin')
    assert digest == PROJECT_DIGESTS['twin_verilog'], f"twin: the Verilog project differs from the reference's ({digest})"
    laps.lap('write')
    t0 = time.perf_counter()
    yn = rtl.predict(data[:TWIN_NETLIST_SAMPLES], backend='netlist')
    net_s = time.perf_counter() - t0
    assert np.array_equal(yn, y[:TWIN_NETLIST_SAMPLES]), 'twin: the netlist differs from K1'
    laps.lap('netlist')
    print(f"[{card}] firmware twin (config-5 nn.Module, {prog.n_in} inputs): trace_model 'cpp' {cpp_s:.3f} s ({len(comb_cpp.ops)} "
          f"ops), 'torch' {dev_s:.3f} s on the card ({len(comb.ops)} ops), each equal to the JAX package's trace with "
          f"the same solver ('jax' for 'torch'); {len(rungs.calls)} rung calls, K2 launched {k2_launches} times, "
          f"{k2_ms:.4f} ms on the card, bound {k2_bound:.6f} ms, each rung call "
          f"({sum(r['iters'] for r in checked)} iterations) equal to its plain version on the card; no init_cache "
          f"call, no host lane", flush=True)  # fmt: skip
    print(f"[{card}] firmware twin: predict on {FIRMWARE_SAMPLES} samples {call_s:.4f} s the first call, "
          f"{warm_s:.4f} s the second (host clock), {launches} K1 launches, K1 {ex.dtype} {ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}; equal to the plain version (max abs err "
          f"{err}), the native host interpreter ({native_s:.3f} s on {native_threads} threads, beside the checks), "
          f"and on the first {TWIN_FORWARD_SAMPLES} the reference "
          f"interpreter and the module's float64 forward (|y| up to "
          f"{np.abs(y).max():.0f}); Verilog ({len(rtl.solution.stages)} stages) written in {write_s:.3f} s "
          f"({n_files} files), equal to the JAX package's; netlist on {TWIN_NETLIST_SAMPLES} samples {net_s:.3f} s, "
          f"equal to K1's rows", flush=True)  # fmt: skip
    print(f'firmware twin wall time by step (host clock, {cpu_model()}): {laps.line()}', flush=True)
    return {'k1_launches': launches, 'k2_launches': k2_launches, 'k2_err': max(r['max_abs_err'] for r in checked),
            'k1_err': err, 'k1_ms': ms, 'k1_bound_ms': bound_ms, 'k2_ms': k2_ms, 'k2_bound_ms': k2_bound,
            'prog': prog}  # fmt: skip


def firmware_precondition(tmp) -> None:
    """``write()`` refuses a corrupted program (``corrupted_mul_program``)
    with ``VerificationError`` before ``src/`` exists; with
    ``DA4ML_VERIFY=0`` it writes."""
    from da4ml_tpu_torch.analysis import VerificationError
    from da4ml_tpu_torch.codegen import VerilogModel

    bad, path = corrupted_mul_program(), tmp / 'bad'
    try:
        VerilogModel(bad, 'bad_model', path).write()
    except VerificationError as e:
        message = str(e)
    else:
        raise AssertionError('the codegen precondition let a corrupted program through')
    assert 'Q210' in message and 'precondition' in message and not (path / 'src').exists(), message
    saved = os.environ.get('DA4ML_VERIFY')
    os.environ['DA4ML_VERIFY'] = '0'
    try:
        VerilogModel(bad, 'bad_model', path).write()
    finally:
        if saved is None:
            del os.environ['DA4ML_VERIFY']
        else:
            os.environ['DA4ML_VERIFY'] = saved
    assert (path / 'src').exists()
    print(f'firmware precondition: a narrowed multiplier interval refused before src/ exists '
          f'({message.splitlines()[1].strip()}); with DA4ML_VERIFY=0 the project is written', flush=True)


def run_firmware(torch, ts, fused_cse, comb, card: str) -> dict:
    """The firmware phase: ``firmware_flagship``, ``firmware_twin`` and
    ``firmware_precondition`` in one scratch directory."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory(prefix='chip_smoke_firmware_') as tmp:
        flagship = firmware_flagship(torch, comb, Path(tmp), card)
        twin = firmware_twin(torch, ts, fused_cse, Path(tmp), card)
        firmware_precondition(Path(tmp))
    return {'flagship': flagship, 'twin': twin}


# ---------------------------------------------------------------------------
# the command line: convert, verify and lint-opcodes as a user runs them
# ---------------------------------------------------------------------------


class CliRun:
    """``python -m da4ml_tpu_torch <args>`` started in a child process (this
    checkout on its path), its output in files under ``tmp``. A child still
    running when this process exits is killed."""

    started: list['CliRun'] = []

    def __init__(self, tmp, label: str, args: list[str], cwd=None):
        import atexit

        if not CliRun.started:
            atexit.register(CliRun.stop_all)
        root = Path(__file__).resolve().parent
        env = dict(os.environ)
        env['PYTHONPATH'] = os.pathsep.join(p for p in (str(root), env.get('PYTHONPATH', '')) if p)
        env.update(PINNED_ENV)  # K1, even when started during the mode='auto' phase
        self.label, self.args = label, args
        self.out, self.err = Path(tmp) / f'{label}.out', Path(tmp) / f'{label}.err'
        self.t0 = time.perf_counter()
        with open(self.out, 'w') as out, open(self.err, 'w') as err:
            self.proc = subprocess.Popen([sys.executable, '-m', 'da4ml_tpu_torch', *args], cwd=cwd or root, env=env,
                                         stdout=out, stderr=err)  # fmt: skip
        CliRun.started.append(self)
        # a watcher notes when the child exits, whenever it is waited for
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()

    @staticmethod
    def stop_all() -> None:
        for run in CliRun.started:
            if run.proc.poll() is None:
                run.proc.kill()
                run.proc.wait()

    def _watch(self) -> None:
        self.proc.wait()
        self.seconds = time.perf_counter() - self.t0

    def wait(self, rc: int = 0, timeout: float = 600) -> str:
        """The child's standard output, once it has exited with ``rc``."""
        self.watcher.join(timeout=timeout)
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
            raise AssertionError(f'cli {self.label} ({" ".join(self.args)}): no exit in {timeout} s, killed')
        got = self.proc.returncode
        if got != rc:
            raise AssertionError(f'cli {self.label} ({" ".join(self.args)}): exit code {got}, not {rc}\n'
                                 f'{self.err.read_text()[-4000:]}\n{self.out.read_text()[-2000:]}')  # fmt: skip
        return self.out.read_text()


def openmp_threads(lib) -> int:
    """``omp_get_max_threads()`` as seen by a loaded emulation library (the
    symbol resolves through the library's own libgomp)."""
    import ctypes

    fn = lib.omp_get_max_threads
    fn.restype = ctypes.c_int
    return int(fn())


def cli_flagship(torch, comb, tmp, card: str) -> dict:
    """The flagship's HLS project written, built with g++ and run on
    ``CLI_FLAGSHIP_SAMPLES`` samples in this process (the data of
    ``convert``'s validation): g++ build seconds, the emulator's seconds and
    thread count (host clock), ``predict(backend='interp')`` through K1 (its
    count reset just before, read just after) equal to the emulator, and K1's
    milliseconds over the stages (CUDA events)."""
    from da4ml_tpu_torch.codegen import HLSModel
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import executor_for_binary

    model = HLSModel(comb, 'model', tmp / 'flagship_timed', latency_cutoff=FIRMWARE_CUTOFF).write()
    t0 = time.perf_counter()
    model.compile()
    build_s = time.perf_counter() - t0
    data = np.random.default_rng(0).uniform(-32, 32, (CLI_FLAGSHIP_SAMPLES, comb.shape[0]))
    y_emu = model.predict(data, backend='emu')  # loads the library
    t0 = time.perf_counter()
    y_emu = model.predict(data, backend='emu')
    emu_s = time.perf_counter() - t0
    threads = openmp_threads(model._load_lib())
    cuda_backend.reset_counts()
    y = model.predict(data, backend='interp')
    torch.cuda.synchronize()
    launches = cuda_backend.launches
    assert np.array_equal(y, y_emu), 'cli flagship: K1 differs from the g++ emulator'
    stage_ms, bound_ms, cur = [], 0.0, data
    for stage in model.solution.stages:
        ex = executor_for_binary(stage.to_binary())
        x = ex.int_inputs(cur)
        stage_ms.append(cuda_ms(lambda: ex.fn_int(x), reps=10))
        bound_ms += k1_bound_ms(ex, len(data))[0]
        cur = ex(cur)
    assert np.array_equal(cur, y)
    print(f"[{card}] cli flagship (HLS, {len(model.solution.stages)} stages): g++ build {build_s:.3f} s (-O2), emulator "
          f"{emu_s:.4f} s on {CLI_FLAGSHIP_SAMPLES} samples with {threads} OpenMP threads (host clock, {cpu_model()}); "
          f"{launches} K1 launches, K1 {sum(stage_ms):.4f} ms over the stages ({', '.join(f'{ms:.4f}' for ms in stage_ms)}), "
          f"bound {bound_ms:.4f} ms; K1 equal to the emulator", flush=True)  # fmt: skip
    return {'k1_launches': launches, 'build_s': build_s, 'emu_s': emu_s, 'threads': threads, 'k1_ms': sum(stage_ms)}


class CliTwinChain:
    """The config-5 twin's two command-line steps, started right after the
    builds in a thread that waits on them (its g++ build is the longest step
    of the run, so it goes beside the other phases): ``convert twin.pt``
    through the device search (K2) to an HLS project, then ``convert
    twin/model/pipeline.json --validate-rtl`` on ``CLI_TWIN_SAMPLES``
    samples (K1 against the g++ emulator)."""

    def __init__(self, torch, tmp):
        from da4ml_tpu_torch.models import config5_twin

        self.tmp, self.error = tmp, None
        torch.save(config5_twin(), tmp / 'twin.pt')
        self.converted = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self) -> None:
        try:
            self.convert = CliRun(self.tmp, 'twin', ['convert', 'twin.pt', 'twin', '--flavor', 'hls', '--solver-backend',
                                                     'torch', '--inputs-kif', '1', '3', '2', '-n', '0'], cwd=self.tmp)
            self.convert.wait()
            self.converted.set()
            self.validate = CliRun(self.tmp, 'twin_validate', ['convert', 'twin/model/pipeline.json', 'twin_v', '--flavor',
                                   'hls', '-n', str(CLI_TWIN_SAMPLES), '--validate-rtl'], cwd=self.tmp)
            self.validate_out = self.validate.wait(timeout=1100)
        except BaseException as e:  # re-raised on the main thread
            self.error = e
        finally:
            self.converted.set()

    def wait_converted(self) -> None:
        self.converted.wait()
        if self.error is not None:
            raise self.error

    def wait(self) -> str:
        self.thread.join()
        if self.error is not None:
            raise self.error
        return self.validate_out


def cli_twin(torch, ts, fused_cse, tmp, card: str) -> dict:
    """The config-5 twin through the same ``convert`` the command line runs,
    in this process: the device search (K2's count reset just before, read
    just after; every rung call recorded, each held to K2's plain version;
    no host lane, no ``init_cache`` call), the project equal to the JAX
    package's (``CLI_DIGESTS['twin_hls']``); ``predict(backend='interp')``
    on ``convert``'s ``CLI_TWIN_SAMPLES`` validation samples through K1 (its
    count reset just before, read just after). Returns the data and K1's
    output, which ``run_cli`` holds to the command line's emulator."""
    from da4ml_tpu_torch._cli.convert import convert
    from da4ml_tpu_torch.models import CONFIG5_INPUTS_KIF
    from da4ml_tpu_torch.runtime import cuda_backend

    laps = Laps()
    pmax0 = ts.search_stats['pmax_host_fallbacks']
    with RungRecorder(ts, fused_cse) as rungs:
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        model = convert(tmp / 'twin.pt', tmp / 'twin_timed', n_test_sample=0, flavor='hls', solver_backend='torch',
                        inputs_kif=CONFIG5_INPUTS_KIF, verbose=0)  # fmt: skip
        torch.cuda.synchronize()
        convert_s = time.perf_counter() - t0
        k2_launches = fused_cse.launches
    assert k2_launches == len(rungs.calls) > 0, 'cli twin: K2 must launch once per rung call'
    assert rungs.init_cache_calls == 0 and ts.search_stats['pmax_host_fallbacks'] == pmax0
    digest = project_digest(tmp / 'twin_timed')
    assert digest == CLI_DIGESTS['twin_hls'], f"cli twin: the HLS project differs from the JAX package's ({digest})"
    laps.lap("convert (trace 'torch', write)")
    checked = [check_rung(torch, ts, fused_cse, inp, spec, f'cli twin {k}', timed=False)
               for k, (inp, spec) in enumerate(rungs.calls)]  # fmt: skip
    k2_ms = k2_rung_ms(torch, ts, fused_cse, rungs.calls)
    laps.lap('rung checks, K2 timed')
    pipe = model.solution
    data = np.random.default_rng(0).uniform(-32, 32, (CLI_TWIN_SAMPLES, pipe.shape[0]))
    cuda_backend.reset_counts()
    y = model.predict(data, backend='interp')
    torch.cuda.synchronize()
    launches = cuda_backend.launches
    assert launches >= len(pipe.stages) and y.shape == (CLI_TWIN_SAMPLES, pipe.shape[1]) and np.isfinite(y).all()
    laps.lap('K1')
    n_ops = sum(len(s.ops) for s in pipe.stages)
    print(f"[{card}] cli twin (config-5 nn.Module through convert, {len(pipe.stages)} stages, {n_ops} ops): convert "
          f"{convert_s:.3f} s with the device search ({len(rungs.calls)} rung calls, K2 launched {k2_launches} times, "
          f"{k2_ms:.4f} ms on the card, bound {rung_bound_ms(checked):.6f} ms, each rung call equal to its plain "
          f"version); HLS project equal to the JAX package's; {launches} K1 launches on {CLI_TWIN_SAMPLES} samples",
          flush=True)  # fmt: skip
    print(f'cli twin wall time by step (host clock, {cpu_model()}): {laps.line()}', flush=True)
    return {'k1_launches': launches, 'k2_launches': k2_launches, 'k2_err': max(r['max_abs_err'] for r in checked),
            'k2_ms': k2_ms, 'data': data, 'y': y}  # fmt: skip


def run_cli(torch, ts, fused_cse, comb, card: str, tmp, chain: CliTwinChain) -> dict:
    """Phase 19: the command line as a user runs it
    (``python -m da4ml_tpu_torch``, each step a child process, its exit code
    checked): the flagship saved as ``.json`` converted to HLS projects in
    each flavour (``CLI_DIGESTS``) and with ``--validate-rtl`` on
    ``CLI_FLAGSHIP_SAMPLES`` samples (K1 against the g++ emulator); the
    config-5 twin's steps (``CliTwinChain``, started after the builds): its
    project equal to the JAX package's (``CLI_DIGESTS['twin_hls']``), its
    validation passed, and the emulator it built equal to K1 in this process
    too; ``verify --conformance`` of the twin's project and ``verify --fuzz``
    (modes numpy, cpp and the executor's four, K1 as pallas) reporting ok; ``verify --json`` of
    ``corrupted_mul_program()`` exiting 1 with the reference's output
    (``VERIFY_DIGEST``); ``lint-opcodes`` exiting 0. In this process, beside
    the children where they would not share a timed span: ``cli_flagship``
    and ``cli_twin``, which count this phase's K1 and K2 launches. Prints
    the phase's wall time by step."""
    from da4ml_tpu_torch.codegen import HLSModel
    from da4ml_tpu_torch.ir import Pipeline

    laps = Laps()
    comb.save(tmp / 'flagship.json')
    corrupted_mul_program().save(tmp / 'corrupted.json')
    runs = {f: CliRun(tmp, f'flagship_{f}', ['convert', 'flagship.json', f, '--flavor', f, '-n', '0'], cwd=tmp)
            for f in ('hls', 'hlslib', 'oneapi')}  # fmt: skip
    runs['corrupted'] = CliRun(tmp, 'corrupted', ['verify', 'corrupted.json', '--json'], cwd=tmp)
    runs['lint'] = CliRun(tmp, 'lint', ['lint-opcodes'])
    runs['fuzz'] = CliRun(tmp, 'fuzz', ['verify', '--fuzz', str(CLI_FUZZ), '--json'], cwd=tmp)
    for f in ('hls', 'hlslib', 'oneapi'):
        runs[f].wait()
        digest = project_digest(tmp / f)
        assert digest == CLI_DIGESTS[f], f"cli: the flagship's {f} project differs from the JAX package's ({digest})"
    out = runs['corrupted'].wait(rc=1)
    assert hashlib.sha256(out.encode()).hexdigest() == VERIFY_DIGEST, f'cli: verify of the corrupted program differs:\n{out}'
    assert 'Q210' in out
    assert runs['lint'].wait().startswith('lint-opcodes: ok')
    fuzz = json.loads(runs['fuzz'].wait())
    assert fuzz['ok'] and fuzz['conformance']['modes'] == ['numpy', 'cpp', 'unroll', 'scan', 'level', 'pallas'], (
        fuzz['conformance']['diagnostics'])
    assert fuzz['conformance']['n_programs'] == CLI_FUZZ and fuzz['transfer_soundness']['ok']
    chain.wait_converted()
    digest = project_digest(tmp / 'twin')
    assert digest == CLI_DIGESTS['twin_hls'], f"cli: the twin's HLS project differs from the JAX package's ({digest})"
    laps.lap('flagship projects, verify of the corrupted program, lint-opcodes, verify --fuzz (children)')
    flagship = cli_flagship(torch, comb, tmp, card)
    laps.lap('flagship in process')
    checks = {
        'flagship_validate': CliRun(tmp, 'flagship_validate', ['convert', 'flagship.json', 'flagship_v', '--flavor', 'hls',
                                    '-n', str(CLI_FLAGSHIP_SAMPLES), '--validate-rtl'], cwd=tmp),
        'conformance': CliRun(tmp, 'conformance', ['verify', 'twin', '--conformance', '--json', '--samples',
                              str(CLI_CONFORMANCE_SAMPLES)], cwd=tmp),
    }  # fmt: skip
    twin = cli_twin(torch, ts, fused_cse, tmp, card)
    laps.lap('twin in process (beside the children)')
    out = checks['flagship_validate'].wait()
    assert f'FUNC validation passed: [0/{CLI_FLAGSHIP_SAMPLES * comb.shape[1]}] mismatches.' in out, out
    flagship['cli_build_s'] = float(re.search(r'emulator built in ([0-9.]+) s', out).group(1))
    report = json.loads(checks['conformance'].wait())
    assert report['ok'] and report['fused']['ok'], (report['diagnostics'], report['fused']['diagnostics'])
    laps.lap('flagship validation and conformance (children, after)')
    out = chain.wait()
    laps.lap("wait for the twin's validation (child)")
    assert f'FUNC validation passed: [0/{CLI_TWIN_SAMPLES * twin["y"].shape[1]}] mismatches.' in out, out
    twin_build_s = float(re.search(r'emulator built in ([0-9.]+) s', out).group(1))
    # the emulator the command line built, loaded here: equal to K1's output
    built = HLSModel(Pipeline.load(tmp / 'twin' / 'model' / 'pipeline.json'), 'model', tmp / 'twin_v')
    assert np.array_equal(built.predict(twin['data'], backend='emu'), twin['y']), 'cli twin: K1 differs from the emulator'
    laps.lap("twin's emulator against K1")
    children = (*runs.values(), chain.convert, *checks.values(), chain.validate)
    seconds = ', '.join(f'{r.label} {r.seconds:.1f} s' for r in children)
    print(f"[{card}] cli: every command exited as it should: the flagship's HLS projects equal the JAX package's; K1 "
          f"equal to the g++ emulator on {CLI_FLAGSHIP_SAMPLES} flagship and {CLI_TWIN_SAMPLES} twin samples; verify "
          f"--conformance ({CLI_CONFORMANCE_SAMPLES} samples, modes numpy, cpp, unroll, scan, level, pallas) and --fuzz {CLI_FUZZ} ok; the "
          f"corrupted program's diagnostics equal the reference's; lint-opcodes ok. g++ builds of the emulator (-O2, "
          f"the command line's): flagship {flagship['cli_build_s']:.3f} s, twin {twin_build_s:.3f} s "
          f"({sum(len(s.ops) for s in built.solution.stages)} ops). Child wall times (host clock, {cpu_model()}): "
          f"{seconds}", flush=True)  # fmt: skip
    print(f'cli wall time by step (host clock, {cpu_model()}): {laps.line()}', flush=True)
    twin = {k: v for k, v in twin.items() if k not in ('data', 'y')}
    return {'flagship': flagship, 'twin': dict(twin, build_s=twin_build_s)}


class BeamClock(Patched):
    """Times the device beam's parts on the host clock, each ended by a device
    synchronize: ``fork`` (``torch_beam.fork_step``: the fan-out's gathers are
    outside it), ``prune`` (``torch_beam.prune``) and ``replay`` (the host's
    ``replay_fork_prefix`` of each surviving fork); with ``keep``, records
    each ``_expand_forks`` call's source lanes (fresh copies) and result."""

    def __init__(self, torch_beam, keep: list | None = None):
        self.seconds = dict.fromkeys(('fork', 'prune', 'replay'), 0.0)
        makers = {(torch_beam, 'fork_step'): timed(self.seconds, 'fork', sync=True),
                  (torch_beam, 'prune'): timed(self.seconds, 'prune', sync=True),
                  (torch_beam, 'replay_fork_prefix'): timed(self.seconds, 'replay')}  # fmt: skip
        if keep is not None:
            makers[torch_beam, '_expand_forks'] = self._keep(torch_beam, keep)
        super().__init__(makers)

    @staticmethod
    def _keep(torch_beam, keep: list):
        def make(real):
            def fn(lanes_sub, spec, adder_size, carry_size, device=None):
                from da4ml_tpu_torch.cmvm.torch_search import _Lane

                copies = [_Lane(ln.kernel, ln.qintervals, ln.latencies, ln.method, perm=ln.perm) for ln in lanes_sub]
                out = real(lanes_sub, spec, adder_size, carry_size, device=device)
                keep.append((copies, spec, adder_size, carry_size, out))
                return out

            return fn

        return make

    def line(self) -> str:
        return ', '.join(f'{k} {v:.4f} s' for k, v in self.seconds.items())


def same_forks(got, want) -> bool:
    """Two beam expansions are the same, fork for fork: source lane, prefix
    (records and digits), the prefix's f32 metadata, and trace meta."""
    return len(got) == len(want) and all(
        gi == wi and gl.prefix.key == wl.prefix.key and gl.prefix.qmeta.tobytes() == wl.prefix.qmeta.tobytes()
        and gl.prefix.lat.tobytes() == wl.prefix.lat.tobytes() and gm == wm
        for (gi, gl, gm), (wi, wl, wm) in zip(got, want)
    )  # fmt: skip


def fork_rung_checks(torch, ts, fused_cse, rungs, label: str, sample: int | None = None) -> tuple[list, list]:
    """The fork rung calls (full-capacity records) of a recorded solve, each
    through K2 and through its plain version on the card (``check_rung``,
    timed); with ``sample``, only that many of them, spread over the solve.
    Returns the checked rows and the base rung calls."""
    forks = [(k, c) for k, c in enumerate(rungs.calls) if c[1].full_rec]
    base = [c for c in rungs.calls if not c[1].full_rec]
    if sample is not None and len(forks) > sample:
        picks = sorted({round(x * (len(forks) - 1) / (sample - 1)) for x in range(sample)})
        forks = [forks[x] for x in picks]
    rows = [check_rung(torch, ts, fused_cse, inp, spec, f'{label} fork {k}') for k, (inp, spec) in forks]
    return rows, base


def quality_flagship(torch, ts, fused_cse, torch_beam, card: str) -> dict:
    """The flagship traced with the device search at each quality (K2's
    count reset just before, read just after; every rung call recorded; the
    beam's parts timed): each program equal to the JAX package's
    (``QUALITY_DIGESTS``), through K1 on ``QUALITY_SAMPLES`` samples and
    held to the reference interpreter on ``QUALITY_REF_SAMPLES``; every fork
    rung call through K2 and its plain version; the search counters."""
    from da4ml_tpu_torch.entry import flagship_comb
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    keys = ('fork_lanes', 'device_forks', 'device_prunes', 'strict_wins', 'ties', 'host_rescues', 'pmax_host_fallbacks')
    data = np.random.default_rng(20261017).uniform(-8, 8, (QUALITY_SAMPLES, 16))
    out = {'k2': {}, 'k1': {}, 'fork_rows': [], 'base_ms': 0.0, 'base_calls': 0, 'err': 0.0}
    for q in ('fast', 'search', 'max'):
        before = dict(ts.search_stats)
        with RungRecorder(ts, fused_cse) as rungs, BeamClock(torch_beam) as beam:
            fused_cse.reset_counts()
            t0 = time.perf_counter()
            comb = flagship_comb(backend='torch', device='cuda', quality=q)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = fused_cse.launches
        st = {k: ts.search_stats[k] - before[k] for k in keys}
        assert launches == len(rungs.calls) > 0 and rungs.init_cache_calls == 0, f'flagship {q}: K2 off its path'
        assert st['pmax_host_fallbacks'] == 0, f'flagship {q}: a lane went to the host solver'
        digest = hashlib.sha256(comb.to_binary().astype('<i4').tobytes()).hexdigest()
        assert digest == QUALITY_DIGESTS[q], f"flagship at {q!r}: the program differs from the JAX package's ({digest})"
        fork_rows, base = fork_rung_checks(torch, ts, fused_cse, rungs, f'flagship {q}')
        assert (q == 'fast') == (not fork_rows), f'flagship {q}: {len(fork_rows)} fork rung calls'
        base_ms = k2_rung_ms(torch, ts, fused_cse, base)
        fork_ms = sum(r['ms'] for r in fork_rows)
        prog = decode(comb.to_binary())
        ex = DaisExecutor(prog)
        cuda_backend.reset_counts()
        y = ex(data)
        torch.cuda.synchronize()
        out['k1'][q] = cuda_backend.launches
        assert out['k1'][q] > 0 and y.shape == (QUALITY_SAMPLES, prog.n_out) and np.isfinite(y).all()
        reference_equal(prog, data[:QUALITY_REF_SAMPLES], y[:QUALITY_REF_SAMPLES])
        out['k2'][q] = launches
        out['cost_' + q] = float(comb.cost)
        out['fork_rows'] += fork_rows
        out['base_ms'] += base_ms
        out['base_calls'] += len(base)
        print(f"[{card}] quality {q!r}, flagship: cost {comb.cost}, {wall:.3f} s wall on the card (host clock, "
              f"{cpu_model()}; the beam's timers synchronize); {len(rungs.calls)} rung calls, K2 launched {launches} "
              f"times: {len(base)} base rung calls {base_ms:.4f} ms, {len(fork_rows)} fork rung calls {fork_ms:.4f} ms "
              f"(bound {rung_bound_ms(fork_rows) if fork_rows else 0.0:.6f} ms; each equal to its plain version); fork "
              f"lanes {st['fork_lanes']}, device forks {st['device_forks']}, prunes {st['device_prunes']}; fork phase "
              f"{beam.line()}; strict wins {st['strict_wins']}, ties {st['ties']}, host rescues {st['host_rescues']}; "
              f"program equal to the JAX package's; K1 {out['k1'][q]} launches on {QUALITY_SAMPLES} samples, the first "
              f"{QUALITY_REF_SAMPLES} equal to the reference interpreter", flush=True)  # fmt: skip
    assert out['cost_search'] <= out['cost_fast'] and out['cost_max'] <= out['cost_fast']
    return out


def quality_corpus(torch, ts, fused_cse, torch_beam, card: str) -> dict:
    """``ci/quality_corpus.npz`` at 'search' on the card against its
    invariants (``ci/quality_gate.py``): never worse than the host oracle,
    at least one strict win, never worse than 'fast', costs equal to the
    JAX package's (``QUALITY_CORPUS_COSTS``); the device beam equal to the
    host beam on the lanes it forked, fork for fork; every fork rung call
    through K2 and its plain version; the wall multiplier over 'fast'."""
    from da4ml_tpu_torch.cmvm import api
    from da4ml_tpu_torch.cmvm.search.beam import expand_beam_lanes

    root = Path(__file__).resolve().parent
    with np.load(root / 'ci' / 'quality_corpus.npz') as blob:
        kernels = [np.asarray(blob[k], np.float64) for k in sorted(blob.files)]
    t0 = time.perf_counter()
    fast = [float(s.cost) for s in ts.solve_torch_many(kernels, device='cuda')]
    torch.cuda.synchronize()
    fast_s = time.perf_counter() - t0
    kept: list = []
    with RungRecorder(ts, fused_cse) as rungs, BeamClock(torch_beam, keep=kept) as beam:
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        sols = ts.solve_torch_many(kernels, quality='search', device='cuda')
        torch.cuda.synchronize()
        beam_s = time.perf_counter() - t0
        launches = fused_cse.launches
    assert launches == len(rungs.calls) > 0 and rungs.init_cache_calls == 0, 'corpus: K2 off its path'
    for k, s in zip(kernels, sols):
        assert np.array_equal(np.asarray(s.kernel, np.float64), k), 'corpus: a solution is not exact'
    costs = [float(s.cost) for s in sols]
    host = [float(api.solve(k, backend='auto').cost) for k in kernels]
    wins = sum(c < h for c, h in zip(costs, host))
    assert all(c <= h for c, h in zip(costs, host)), f'corpus: worse than the host oracle: {costs} vs {host}'
    assert wins >= 1, f'corpus: no strict win over the host oracle: {costs} vs {host}'
    assert all(c <= f for c, f in zip(costs, fast)), f"corpus: worse than 'fast': {costs} vs {fast}"
    assert costs == QUALITY_CORPUS_COSTS, f"corpus: costs differ from the JAX package's: {costs}"
    for lanes, spec, a, c, got in kept:
        assert same_forks(got, expand_beam_lanes(lanes, spec, a, c)), 'corpus: the device beam differs from the host beam'
    fork_rows, base = fork_rung_checks(torch, ts, fused_cse, rungs, 'corpus')
    assert fork_rows, 'corpus: no fork rung call'
    base_ms = k2_rung_ms(torch, ts, fused_cse, base)
    print(f"[{card}] quality 'search', corpus ({len(kernels)} kernels): costs {costs}, host oracle {host}, 'fast' {fast}: "
          f"{wins} strict wins, never worse than the oracle or 'fast', equal to the JAX package's; wall {beam_s:.3f} s "
          f"against 'fast' {fast_s:.3f} s ({beam_s / fast_s:.2f}x, host clock; the beam's timers synchronize); fork "
          f"phase {beam.line()}; device beam equal to the host beam on {sum(len(k[4]) for k in kept)} forks; K2 "
          f"launched {launches} times: {len(base)} base rung calls {base_ms:.4f} ms, {len(fork_rows)} fork rung calls "
          f"{sum(r['ms'] for r in fork_rows):.4f} ms (bound {rung_bound_ms(fork_rows):.6f} ms), each equal to its "
          f"plain version", flush=True)  # fmt: skip
    return {'k2': launches, 'fork_rows': fork_rows, 'base_ms': base_ms, 'base_calls': len(base)}


def quality_config5(torch, ts, fused_cse, torch_beam, card: str, fast_cost: float) -> dict:
    """The config-5 model traced at 'search' on the card: never worse than
    'fast', equal to the JAX package's trace (``QUALITY_DIGESTS``), K1 on
    ``MODEL_SAMPLES`` samples equal to its plain version, and
    ``CONFIG5_FORK_CHECKS`` of its fork rung calls through K2 and its plain
    version."""
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    with RungRecorder(ts, fused_cse) as rungs, BeamClock(torch_beam) as beam:
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        comb = config5_model('torch', quality='search', device='cuda')
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_cse.launches
    assert launches == len(rungs.calls) > 0 and rungs.init_cache_calls == 0, 'config 5 at search: K2 off its path'
    assert float(comb.cost) <= fast_cost, f"config 5 at 'search': cost {comb.cost} over 'fast' {fast_cost}"
    digest = hashlib.sha256(comb.to_binary().astype('<i4').tobytes()).hexdigest()
    assert digest == QUALITY_DIGESTS['config5'], f"config 5 at 'search' differs from the JAX package's ({digest})"
    fork_rows, base = fork_rung_checks(torch, ts, fused_cse, rungs, 'config 5', sample=CONFIG5_FORK_CHECKS)
    assert len(fork_rows) >= min(CONFIG5_FORK_CHECKS, 1), 'config 5 at search: no fork rung call'
    n_fork = sum(1 for _, s in rungs.calls if s.full_rec)
    prog = decode(comb.to_binary())
    data = np.random.default_rng(20261019).uniform(-8, 8, (MODEL_SAMPLES, prog.n_in))
    ex = DaisExecutor(prog)
    cuda_backend.reset_counts()
    y = ex(data)
    torch.cuda.synchronize()
    k1 = cuda_backend.launches
    assert k1 > 0 and y.shape == (MODEL_SAMPLES, prog.n_out) and np.isfinite(y).all()
    err = k1_equal_plain(torch, ex, ex.int_inputs(data), MODEL_PLAIN_ROWS)
    print(f"[{card}] quality 'search', config 5: cost {comb.cost} ('fast' {fast_cost}), {wall:.3f} s wall on the card "
          f"(host clock; the beam's timers synchronize); fork phase {beam.line()}; {len(rungs.calls)} rung calls, K2 "
          f"launched {launches} times, {n_fork} of them fork rung calls, {len(fork_rows)} of those held to the plain "
          f"version ({sum(r['ms'] for r in fork_rows):.4f} ms); program equal to the JAX package's; K1 {k1} launches "
          f"on {MODEL_SAMPLES} samples, equal to its plain version (max abs err {err})", flush=True)  # fmt: skip
    return {'k2': launches, 'k1': k1, 'fork_rows': fork_rows, 'err': err}


def run_quality(torch, ts, fused_cse, card: str, tmp, config5_cost: float) -> dict:
    """Phase 15: the quality search on the card — the flagship at each
    quality, the quality corpus at 'search', config 5 at 'search', and the
    command line's ``convert --quality search`` of the config-5 twin in a
    child process (its Verilog project equal to the JAX package's), and the
    same with the default 'auto' backend, which degrades with a warning.
    Prints the phase's wall time by step."""
    from da4ml_tpu_torch.cmvm import torch_beam

    laps = Laps()
    common = ['--flavor', 'verilog', '--inputs-kif', '1', '3', '2', '-n', '0', '--quality', 'search']
    children = {'torch': CliRun(tmp, 'quality_torch', ['convert', 'twin.pt', 'quality_torch', *common, '--solver-backend',
                                                       'torch'], cwd=tmp),
                'auto': CliRun(tmp, 'quality_auto', ['convert', 'twin.pt', 'quality_auto', *common], cwd=tmp)}  # fmt: skip
    flag = quality_flagship(torch, ts, fused_cse, torch_beam, card)
    laps.lap('flagship')
    corpus = quality_corpus(torch, ts, fused_cse, torch_beam, card)
    laps.lap('corpus')
    model = quality_config5(torch, ts, fused_cse, torch_beam, card, config5_cost)
    laps.lap('config 5')
    children['torch'].wait()
    digest = project_digest(tmp / 'quality_torch')
    assert digest == QUALITY_DIGESTS['twin_cli'], f"quality cli: the twin's project differs from the JAX package's ({digest})"
    children['auto'].wait()
    warned = children['auto'].err.read_text()
    assert 'portfolio sweep' in warned, f'quality cli: no degrade warning from the auto backend:\n{warned[-2000:]}'
    laps.lap('command line (children, after)')
    print(f"quality cli: convert --quality search --solver-backend torch {children['torch'].seconds:.1f} s, project "
          f"equal to the JAX package's; with the default 'auto' backend {children['auto'].seconds:.1f} s, exit 0, "
          f"warned: {next(ln for ln in warned.splitlines() if 'portfolio sweep' in ln).strip()[-200:]}",
          flush=True)  # fmt: skip
    print(f'quality wall time by step (host clock, {cpu_model()}): {laps.line()}', flush=True)
    rows = flag['fork_rows'] + corpus['fork_rows'] + model['fork_rows']
    fork_ms = sum(r['ms'] for r in flag['fork_rows'] + corpus['fork_rows'])
    print(f"[{card}] quality: fork rung calls of the flagship and the corpus: {len(flag['fork_rows']) + len(corpus['fork_rows'])}, "
          f"K2 {fork_ms:.4f} ms, bound {rung_bound_ms(flag['fork_rows'] + corpus['fork_rows']):.6f} ms; base rung calls "
          f"{flag['base_calls'] + corpus['base_calls']}, K2 {flag['base_ms'] + corpus['base_ms']:.4f} ms", flush=True)  # fmt: skip
    return {'k2_paths': {f'quality_flagship_{q}': n for q, n in flag['k2'].items()} | {'quality_corpus': corpus['k2'],
                                                                                     'quality_config5': model['k2']},
            'k1_paths': {f'quality_flagship_{q}': n for q, n in flag['k1'].items()} | {'quality_config5': model['k1']},
            'k2_err': max(r['max_abs_err'] for r in rows), 'k1_err': model['err']}  # fmt: skip


# ---------------------------------------------------------------------------
# the resident rung ladder against the host-state one
# ---------------------------------------------------------------------------


@contextmanager
def environ(**values: str):
    """``os.environ`` with ``values`` set for the block; restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextmanager
def ladder(resident: bool):
    """The device search's rung ladder for the block:
    ``DA4ML_JAX_DEVICE_RESIDENT`` set, and ``entry._FLAGSHIP`` emptied (its
    key lacks the switch, so a cached program would come back unsolved); both
    restored after."""
    from da4ml_tpu_torch import entry

    cached = dict(entry._FLAGSHIP)
    entry._FLAGSHIP.clear()
    try:
        with environ(DA4ML_JAX_DEVICE_RESIDENT='1' if resident else '0'):
            yield
    finally:
        entry._FLAGSHIP.clear()
        entry._FLAGSHIP.update(cached)


@contextmanager
def ladder_metrics():
    """The search's metrics on, and empty, for the block; yields a dict that
    holds the ladder's counters after it: uploaded and fetched bytes, rungs,
    resident rungs, asynchronous emissions and their summed wait."""
    from da4ml_tpu_torch.telemetry import metrics as tm

    was = tm.metrics_on()
    tm.enable_metrics()
    tm.reset_metrics()
    counts: dict = {}
    try:
        yield counts
    finally:
        snap = tm.metrics_snapshot()
        tm.reset_metrics()
        if not was:
            tm.disable_metrics()
        for k in ('sched.upload_bytes', 'sched.fetch_bytes', 'sched.device_resident_rungs', 'sched.rungs',
                  'emit.async_batches'):  # fmt: skip
            counts[k.split('.')[1]] = snap.get(k, {}).get('value', 0)
        counts['async_wait'] = snap.get('emit.async_wait_s', {}).get('sum', 0.0)


def ladder_solve(torch, fused_cse, solve, resident: bool) -> dict:
    """``solve()`` on one ladder with the search's metrics on: its result,
    host-clock seconds (ended by a synchronize), K2's launches (its count
    reset just before, read just after), the device memory its peak took
    above what was allocated before, and the ladder's counters
    (:func:`ladder_metrics`)."""
    with ladder(resident), ladder_metrics() as counts:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        out = solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fused_cse.launches
        peak = torch.cuda.max_memory_allocated() - base
    return {'out': out, 'wall': wall, 'k2': launches, 'peak_mib': peak / 2**20, **counts}


def ladder_line(r: dict) -> str:
    return (f"{r['wall']:.4f} s, K2 {r['k2']}, rungs {r['rungs']:.0f} ({r['device_resident_rungs']:.0f} resident), "
            f"uploaded {r['upload_bytes']:.0f} B, fetched {r['fetch_bytes']:.0f} B, emission waited "
            f"{r['async_wait']:.6f} s over {r['async_batches']:.0f} asynchronous groups")  # fmt: skip


def run_resident(torch, ts, fused_cse, card: str, held: dict) -> None:
    """The resident rung ladder (the default) against the host-state one
    (``DA4ML_JAX_DEVICE_RESIDENT=0``) on the card, around the solve cache:
    the flagship at ``'fast'`` solved anew eight times in turns
    (``LADDER_TURNS`` twice), each byte-identical to phase 4's program with
    phase 4's K2 launches, and each ladder's median wall; a resident solve with every
    finished lane's fetched digits held to ``torch_search._replay_digits``
    (the replay's host seconds beside the ladder's own fetches, which the
    stage timers' synchronizes separate from K2's); the flagship at
    ``'search'`` on both ladders and ``bench.py``'s four wider layers
    host-state, each equal to its resident solve of phases 15 and 7 with the
    same K2 launches; config 5 (``'torch'``) twice on each ladder, in turns,
    each equal to phase 9's trace with its K2 launches, for their walls and
    peak device memory; and the flagship with ``DEVICE_BUDGET`` at
    ``SPILL_BUDGET``, so that the carry spills to host state before a split
    rung. Each solve's wall, K2 launches and ladder counters (uploaded and
    fetched bytes, resident rungs, emission waits) are printed. These solves
    repeat ones the earlier phases made and checked rung by rung, and only
    their programs are compared here: their K2 launches are comparison
    launches, printed by solve and not counted in the kernel table."""
    from da4ml_tpu_torch.cmvm import solve_torch_many
    from da4ml_tpu_torch.entry import flagship_comb

    laps = Laps()
    flag_bin = held['flagship'].to_binary()
    runs = {True: [], False: []}
    for resident in LADDER_TURNS * 2:
        r = ladder_solve(torch, fused_cse, lambda: flagship_comb(backend='torch'), resident)
        assert np.array_equal(r['out'].to_binary(), flag_bin), f'flagship: the {resident=} ladder differs from phase 4'
        assert r['k2'] == held['flagship_k2'], f"flagship: K2 launched {r['k2']} times ({resident=})"
        assert (r['device_resident_rungs'] > 0) == resident, r
        runs[resident].append(r)
    for resident in (True, False):
        for r in runs[resident]:
            print(f"[{card}] resident ladder, flagship 'fast', {'resident' if resident else 'host-state'}: "
                  f"{ladder_line(r)}, peak {r['peak_mib']:.2f} MiB above the allocated", flush=True)  # fmt: skip
    print(f"[{card}] resident ladder, flagship 'fast': median wall resident "
          f"{statistics.median(r['wall'] for r in runs[True]):.4f} s, host-state "
          f"{statistics.median(r['wall'] for r in runs[False]):.4f} s (host clock, in turns)", flush=True)  # fmt: skip
    laps.lap('flagship')

    with ladder(True), ts.record_finished() as finished, RungRecorder(ts, fused_cse, stages=True) as staged:
        comb = flagship_comb(backend='torch')
    assert np.array_equal(comb.to_binary(), flag_bin), 'flagship: the staged resident solve differs from phase 4'
    t0 = time.perf_counter()
    for E0, rec, n_applied, n_in_max, cur, O, B, E in finished:
        want = ts._replay_digits(E0, rec, n_applied, n_in_max, cur, O, B)
        assert np.array_equal(E[:cur], want[:cur]) and not E[cur:].any(), 'a fetched lane differs from its replay'
    replay_s = time.perf_counter() - t0
    n_replayed = sum(len(rec) - n_applied for _, rec, n_applied, *_ in finished)
    stages = ', '.join(f'{k} {v:.4f} s' for k, v in staged.seconds.items())
    print(f"[{card}] resident ladder, flagship 'fast': {len(finished)} finished lanes' fetched digits equal to the "
          f"host replay of their {n_replayed} records; replay {replay_s:.4f} s (host clock, {cpu_model()}), the "
          f"ladder's fetches {staged.seconds['fetch']:.4f} s (each after K2's synchronize); rung stages {stages}",
          flush=True)  # fmt: skip
    laps.lap('replay')

    search = {}
    for resident in (True, False):
        r = search[resident] = ladder_solve(torch, fused_cse, lambda: flagship_comb(backend='torch', quality='search'),
                                            resident)  # fmt: skip
        digest = hashlib.sha256(r['out'].to_binary().astype('<i4').tobytes()).hexdigest()
        assert digest == QUALITY_DIGESTS['search'], f"flagship at 'search': the {resident=} ladder differs ({digest})"
        assert np.array_equal(r['out'].to_binary(), held['search'].to_binary())
        assert r['k2'] == held['search_k2'], f"flagship at 'search': K2 {r['k2']} against {held['search_k2']}"
        assert (r['device_resident_rungs'] > 0) == resident, r
        print(f"[{card}] resident ladder, flagship 'search', {'resident' if resident else 'host-state'}: "
              f"{ladder_line(r)}; byte-identical to phase 15's solve (K2 {held['search_k2']})", flush=True)  # fmt: skip
    wide = ladder_solve(torch, fused_cse, lambda: solve_torch_many(held['wide_kernels']), False)
    for s, w in zip(wide['out'], held['wide']):
        assert same_solution(s, w), 'wider layers: the host-state ladder differs from phase 7'
    assert wide['k2'] == held['wide_k2'], f"wider layers: K2 {wide['k2']} against {held['wide_k2']}"
    print(f"[{card}] resident ladder, wider layers, host-state: {ladder_line(wide)}; op for op phase 7's resident "
          f"solve (K2 {held['wide_k2']})", flush=True)  # fmt: skip
    laps.lap('search and wider layers')

    c5 = {True: [], False: []}
    for resident in LADDER_TURNS[::-1]:
        r = ladder_solve(torch, fused_cse, lambda: config5_model('torch'), resident)
        c5[resident].append(r)
        assert np.array_equal(r['out'].to_binary(), held['config5']), f'config 5: the {resident=} trace differs from phase 9'
        assert r['k2'] == held['config5_k2'], f"config 5: K2 {r['k2']} against {held['config5_k2']} ({resident=})"
        print(f"[{card}] resident ladder, config 5 ('torch' trace), {'resident' if resident else 'host-state'}: "
              f"{ladder_line(r)}, peak {r['peak_mib']:.2f} MiB above the allocated; byte-identical to phase 9's trace",
              flush=True)  # fmt: skip
    laps.lap('config 5')

    spills = {'n': 0}
    with Patched({(ts, 'DEVICE_BUDGET'): lambda _: SPILL_BUDGET, (ts, '_fetch_carry'): counted(spills, 'n')}):
        spill = ladder_solve(torch, fused_cse, lambda: flagship_comb(backend='torch'), True)
    assert spills['n'] > 0, 'the carry never spilled'
    assert np.array_equal(spill['out'].to_binary(), flag_bin), 'flagship: the spilling solve differs from phase 4'
    print(f"[{card}] resident ladder, flagship 'fast' at DEVICE_BUDGET {SPILL_BUDGET} B: {spills['n']} spills of the "
          f"carry; {ladder_line(spill)}; byte-identical to phase 4", flush=True)  # fmt: skip
    laps.lap('spill')
    print(f'resident ladder wall time by step (host clock, {cpu_model()}): {laps.line()}', flush=True)
    launches = {'flagship': sum(r['k2'] for rs in runs.values() for r in rs),
                'search': sum(r['k2'] for r in search.values()), 'wide_host_state': wide['k2'],
                'config5': sum(r['k2'] for rs in c5.values() for r in rs), 'spill': spill['k2']}  # fmt: skip
    print(f"[{card}] resident ladder: K2's comparison launches (not in the kernel table) {launches}", flush=True)


# ---------------------------------------------------------------------------
# telemetry: the command line's trace, the device profile, the overhead of
# the instrumentation, the live endpoint
# ---------------------------------------------------------------------------


def profile_child(out: Path) -> int:
    """The device-profile run, in a process of its own with ``DA4ML_PROFILE``
    and ``DA4ML_TRACE`` set in its environment before the port is imported:
    the flagship solved twice by the device search (K2; the second solve is
    the measured one), each program byte-identical to the JAX package's
    (``QUALITY_DIGESTS['fast']``), then the flagship program called twice on
    ``FLAGSHIP_SAMPLES`` samples (K1), the output's first
    ``QUALITY_REF_SAMPLES`` rows equal to the reference interpreter's. Each
    solve runs inside a ``smoke.solve`` span. Stops the profiler (which
    writes its Chrome trace), closes the span trace, and prints one JSON
    line: both files, the K1 and K2 launch counts (the wrappers' own, reset
    just before), and the host seconds of each solve and call."""
    import torch

    from da4ml_tpu_torch import telemetry
    from da4ml_tpu_torch.cmvm import fused_cse
    from da4ml_tpu_torch.entry import flagship_comb
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor
    from da4ml_tpu_torch.telemetry.obs import profile

    assert profile.profile_dir() and telemetry.tracing_active(), 'DA4ML_PROFILE and DA4ML_TRACE must be set'
    torch.zeros(1, device='cuda')  # the CUDA context, outside every span
    torch.cuda.synchronize()
    fused_cse.reset_counts()
    cuda_backend.reset_counts()
    solve_s, call_s = [], []
    for k, dev in enumerate(('cuda', 'cuda:0')):  # another device string is another cache key: a new solve
        t0 = time.perf_counter()
        with telemetry.span('smoke.solve', k=k):
            comb = flagship_comb(backend='torch', device=dev)
        solve_s.append(time.perf_counter() - t0)
        digest = hashlib.sha256(comb.to_binary().astype('<i4').tobytes()).hexdigest()
        assert digest == QUALITY_DIGESTS['fast'], f"profile child: the flagship differs from the JAX package's ({digest})"
    prog = decode(comb.to_binary())
    ex = DaisExecutor(prog)
    data = np.random.default_rng(20260729).uniform(-8, 8, (FLAGSHIP_SAMPLES, comb.shape[0]))
    for _ in range(2):
        t0 = time.perf_counter()
        y = ex(data)
        call_s.append(time.perf_counter() - t0)
    launches = {'k1': cuda_backend.launches, 'k2': fused_cse.launches}
    path = profile.stop()
    telemetry.disable()
    assert y.shape == (FLAGSHIP_SAMPLES, comb.shape[1]) and np.isfinite(y).all()
    reference_equal(prog, data[:QUALITY_REF_SAMPLES], y[:QUALITY_REF_SAMPLES])
    print(json.dumps({'profile': path, 'trace': os.environ['DA4ML_TRACE'], **launches, 'solve_s': solve_s,
                      'call_s': call_s}))  # fmt: skip
    return 0


#: the kernels' function names as the profiler lists them (a substring of
#: each instantiation's name)
PROFILE_KERNELS = {'dais_exec': 'dais_exec_kernel', 'fused_cse': 'fused_cse_kernel'}


def profile_kernels(events: list[dict]) -> list[dict]:
    """Every K1 and K2 kernel event of a ``torch.profiler`` Chrome trace, each
    with the ``da4ml:`` range it ran in: ``{kernel, ts, dur, range, span,
    how}``. ``how`` says how the range was found: ``'launch'`` (the kernel's
    launch call, matched by its correlation id, lies inside a host
    ``da4ml:`` range on the launching thread), ``'gpu range'`` (a
    ``gpu_user_annotation`` ``da4ml:`` range holds the kernel), ``'time'``
    (a host ``da4ml:`` range holds the kernel's run), or None."""
    host = [e for e in events if e.get('ph') == 'X' and str(e.get('name', '')).startswith('da4ml:')
            and e.get('cat') != 'gpu_user_annotation']  # fmt: skip
    gpu = [e for e in events if e.get('ph') == 'X' and str(e.get('name', '')).startswith('da4ml:')
           and e.get('cat') == 'gpu_user_annotation']  # fmt: skip
    launch = {e['args']['correlation']: e for e in events if e.get('ph') == 'X' and e.get('cat') in ('cuda_runtime', 'cuda_driver')
              and 'correlation' in e.get('args', {})}  # fmt: skip

    def within(rs, ts, end, tid=None):
        hits = [r for r in rs if r['ts'] <= ts and end <= r['ts'] + r['dur'] and (tid is None or r.get('tid') == tid)]
        return min(hits, key=lambda r: r['dur']) if hits else None

    out = []
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') != 'kernel':
            continue
        kind = next((k for k, sub in PROFILE_KERNELS.items() if sub in str(e.get('name', ''))), None)
        if kind is None:
            continue
        ts, end = float(e['ts']), float(e['ts']) + float(e['dur'])
        how, r = None, None
        call = launch.get(e.get('args', {}).get('correlation'))
        if call is not None:
            r = within(host, float(call['ts']), float(call['ts']) + float(call['dur']), call.get('tid'))
            how = 'launch' if r else None
        if r is None:
            r = within(gpu, ts, end)
            how = 'gpu range' if r else None
        if r is None:
            r = within(host, ts, end)
            how = 'time' if r else None
        name = r['name'] if r else None
        span = int(name.split('#span=')[1]) if name and '#span=' in name else None
        out.append({'kernel': kind, 'ts': ts, 'dur': float(e['dur']), 'range': name and name.split('#')[0], 'span': span,
                    'how': how})  # fmt: skip
    return out


def busy_shares(kernels: list[dict], spans: list[dict]) -> dict:
    """Each kernel's summed device time over the wall time of the telemetry
    span that encloses it: K1 per ``run.call`` span (the last call), K2 per
    ``smoke.solve`` span (the second solve), walking each kernel's range's
    span up the trace's parent links."""
    by_id = {e['args']['span_id']: e for e in spans if e.get('ph') == 'X' and 'span_id' in e.get('args', {})}

    def ancestor(sid, name):
        while sid is not None and sid in by_id:
            if by_id[sid]['name'] == name:
                return by_id[sid]
            sid = by_id[sid]['args'].get('parent_id')
        return None

    out = {}
    for kind, name in (('dais_exec', 'run.call'), ('fused_cse', 'smoke.solve')):
        per: dict[int, float] = {}
        for k in kernels:
            if k['kernel'] == kind:
                sp = ancestor(k['span'], name)
                if sp is not None:
                    per[sp['args']['span_id']] = per.get(sp['args']['span_id'], 0.0) + k['dur']
        assert per, f'no {kind} kernel inside a {name} span'
        last = max(per, key=lambda sid: by_id[sid]['ts'])
        out[kind] = {'span': name, 'kernel_us': per[last], 'span_us': float(by_id[last]['dur']),
                     'share': per[last] / float(by_id[last]['dur']), 'spans': len(per)}  # fmt: skip
    return out


def telemetry_cli(torch, tmp, card: str) -> dict:
    """``convert --trace`` in a child (the flagship twin's ``.pt`` through K2,
    validation on K1, Verilog): the port's ``validate_trace`` passes the
    trace, which holds ``cmvm.solve``, ``run.call`` and ``codegen.rtl.write``
    and K1's build metrics (``run.pallas.*``, recorded at a launch on the
    card only); ``stats`` and ``trace-view`` read it and exit 0. The child's
    K1 and K2 launches stay in the child: they join no launch count."""
    import contextlib
    import io

    from da4ml_tpu_torch import telemetry
    from da4ml_tpu_torch._cli import main as cli_main
    from da4ml_tpu_torch.models import CONFIG5_INPUTS_KIF, flagship_twin

    torch.save(flagship_twin(), tmp / 'flagship.pt')
    run = CliRun(tmp, 'telemetry_convert', ['convert', 'flagship.pt', 'tel_prj', '--solver-backend', 'torch',
                                            '--inputs-kif', *map(str, CONFIG5_INPUTS_KIF), '--trace', 't.json'],
                 cwd=tmp)  # fmt: skip
    run.wait(timeout=300)
    events, metrics = telemetry.load_trace(tmp / 't.json')
    telemetry.validate_trace(events)
    names = {e['name'] for e in events}
    assert {'cmvm.solve', 'run.call', 'codegen.rtl.write'} <= names, f'telemetry cli: the trace lacks spans: {names}'
    assert {'run.pallas.compile_s', 'run.pallas.vmem_bytes', 'run.mode.pallas', 'sched.device_s'} <= set(metrics), sorted(metrics)
    mism = json.loads((tmp / 'tel_prj' / 'mismatches.json').read_text())
    assert mism['n_mismatch'] == 0, f'telemetry cli: {mism}'
    outs = {}
    for label, argv in (('stats', ['stats', str(tmp / 't.json'), '--validate']),
                        ('trace-view', ['trace-view', str(tmp / 't.json'), '--out', str(tmp / 'merged.json')])):  # fmt: skip
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(argv)
        assert rc == 0, f'telemetry cli: {label} exited {rc}'
        outs[label] = buf.getvalue()
    assert f'{len(events)} events' in outs['stats'] and 'cmvm.solve' in outs['stats']
    rounds = int(metrics['cse.device_rounds']['value'])
    print(f"telemetry cli: convert --trace of the flagship twin {run.seconds:.1f} s, {len(events)} events in "
          f"{len(names)} span names, valid; {rounds} device rung calls (cse.device_rounds), 0 mismatches; stats and "
          f"trace-view exit 0; the summary's top spans:", flush=True)  # fmt: skip
    for line in outs['stats'].splitlines()[1:8]:
        print(f'  {line}')


def telemetry_profile(torch, tmp, card: str) -> dict:
    """The device profile (``profile_child`` in a child process): the
    exported profile must hold the K1 and K2 kernel events, each inside its
    ``da4ml:`` range (``run.call`` for K1, ``cmvm.rung`` for K2); prints the
    busy shares (``busy_shares``)."""
    from da4ml_tpu_torch.telemetry import load_trace

    pdir = tmp / 'profile'
    env = dict(os.environ, DA4ML_PROFILE=str(pdir), DA4ML_TRACE=str(pdir / 'spans.json'))
    root = Path(__file__).resolve().parent
    env['PYTHONPATH'] = os.pathsep.join(p for p in (str(root), env.get('PYTHONPATH', '')) if p)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), '--profile-child', str(pdir)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)  # fmt: skip
    child_s = time.perf_counter() - t0
    assert proc.returncode == 0, f'profile child: exit {proc.returncode}\n{proc.stderr[-4000:]}\n{proc.stdout[-2000:]}'
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got['profile'], f'profile child: no profile written\n{proc.stderr[-2000:]}'
    doc = json.loads(Path(got['profile']).read_text())
    events = doc['traceEvents'] if isinstance(doc, dict) else doc
    kernels = profile_kernels(events)
    spans, _ = load_trace(got['trace'])
    n = {k: sum(e['kernel'] == k for e in kernels) for k in PROFILE_KERNELS}
    hows = {}
    for e in kernels:
        hows[e['how']] = hows.get(e['how'], 0) + 1
    print(f"[{card}] telemetry profile: child {child_s:.1f} s; {len(events)} profile events, {n['dais_exec']} K1 and "
          f"{n['fused_cse']} K2 kernel events (the child launched K1 {got['k1']} and K2 {got['k2']} times); ranges "
          f"found by {hows}; device solves {', '.join(f'{s:.3f}' for s in got['solve_s'])} s, calls "
          f"{', '.join(f'{s:.4f}' for s in got['call_s'])} s (host clock)", flush=True)  # fmt: skip
    assert n['dais_exec'] == got['k1'] > 0 and n['fused_cse'] == got['k2'] > 0, 'the profile lacks kernel events'
    outside = [e for e in kernels if e['range'] != {'dais_exec': 'da4ml:run.call', 'fused_cse': 'da4ml:cmvm.rung'}[e['kernel']]]
    assert not outside, f'kernels outside their da4ml: range: {outside[:4]}'
    shares = busy_shares(kernels, spans)
    for kind, b in shares.items():
        print(f"[{card}] busy share, {kind}: {b['kernel_us'] / 1e3:.4f} ms of kernel time in a {b['span']} span of "
              f"{b['span_us'] / 1e3:.4f} ms: {100 * b['share']:.2f} % ({b['spans']} such spans)", flush=True)  # fmt: skip
    return {'k1_launches': got['k1'], 'k2_launches': got['k2'], 'shares': shares}


def telemetry_overhead(torch, comb, tmp, card: str) -> dict:
    """The flagship call (``FLAGSHIP_SAMPLES`` samples through K1, host
    clock) with telemetry off, with ``enable()`` (metrics) and with
    ``enable(path)`` (metrics and spans into a JSONL sink): the median of
    ``TELEMETRY_REPEATS`` calls each, after one warm call whose first
    ``QUALITY_REF_SAMPLES`` rows equal the reference interpreter's; every
    timed call's output equals the warm call's."""
    from da4ml_tpu_torch import telemetry
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    prog = decode(comb.to_binary())
    ex = DaisExecutor(prog)
    data = np.random.default_rng(20260729).uniform(-8, 8, (FLAGSHIP_SAMPLES, comb.shape[0]))
    assert not telemetry.metrics_on() and not telemetry.tracing_active()
    cuda_backend.reset_counts()
    want = ex(data)
    reference_equal(prog, data[:QUALITY_REF_SAMPLES], want[:QUALITY_REF_SAMPLES])
    med = {}
    for label, path in (('off', None), ('enable()', ''), ('enable(path)', tmp / 'overhead.jsonl'), ('off again', None)):
        if path is not None:
            telemetry.enable(path or None)
        times = []
        for _ in range(TELEMETRY_REPEATS):
            t0 = time.perf_counter()
            y = ex(data)
            times.append(time.perf_counter() - t0)
        assert np.array_equal(y, want)
        med[label] = statistics.median(times)
        telemetry.reset()
    launches = cuda_backend.launches
    x = ex.int_inputs(data)
    k1_ms = cuda_ms(lambda: ex.fn_int(x), reps=20)
    print(f"[{card}] telemetry overhead, the flagship call on {FLAGSHIP_SAMPLES} samples (host clock, median of "
          f"{TELEMETRY_REPEATS}): {', '.join(f'{k} {v * 1e3:.3f} ms' for k, v in med.items())}; K1 alone "
          f"{k1_ms:.4f} ms (CUDA events, telemetry off)", flush=True)  # fmt: skip
    return {'k1_launches': launches, 'medians': med, 'k1_ms': k1_ms}


def telemetry_endpoint(torch, comb, card: str) -> dict:
    """``telemetry.serve()`` on an ephemeral port; one flagship call, its
    output equal to the reference interpreter's; one scrape of ``/metrics``
    held to ``validate_openmetrics``, and ``/healthz`` and ``/statusz``
    read."""
    import urllib.request

    from da4ml_tpu_torch import telemetry
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor
    from da4ml_tpu_torch.telemetry.obs import stop_server, validate_openmetrics

    server = telemetry.serve(port=0)
    try:
        prog = decode(comb.to_binary())
        ex = DaisExecutor(prog)
        data = np.random.default_rng(1).uniform(-8, 8, (4096, comb.shape[0]))
        cuda_backend.reset_counts()
        y = ex(data)
        launches = cuda_backend.launches
        reference_equal(prog, data, y)
        t0 = time.perf_counter()
        with urllib.request.urlopen(f'{server.url}/metrics', timeout=30) as r:
            text = r.read().decode()
        scrape_s = time.perf_counter() - t0
        fams = validate_openmetrics(text)
        assert fams['da4ml_run_samples']['samples']['da4ml_run_samples_total'] == 4096, 'scrape: run.samples'
        with urllib.request.urlopen(f'{server.url}/healthz', timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f'{server.url}/statusz', timeout=30) as r:
            status = json.loads(r.read())
        assert health['status'] == 'ok' and status['devices']['count'] >= 1, (health, status['devices'])
    finally:
        stop_server()
        telemetry.reset()
    print(f"telemetry endpoint: /metrics at {server.url} valid OpenMetrics, {len(fams)} families, {len(text)} bytes, "
          f"scraped in {scrape_s * 1e3:.2f} ms; /healthz {health['status']}; /statusz lists "
          f"{status['devices']['devices'][0]['name']}", flush=True)  # fmt: skip
    return {'k1_launches': launches}


def run_telemetry(torch, comb, card: str) -> dict:
    """The telemetry phase: ``telemetry_cli``, ``telemetry_profile``,
    ``telemetry_overhead`` and ``telemetry_endpoint``, in that order. Prints
    the phase's wall time by step."""
    laps = Laps()
    with tempfile.TemporaryDirectory(prefix='chip_smoke_telemetry_') as d:
        tmp = Path(d)
        telemetry_cli(torch, tmp, card)
        laps.lap('command line')
        prof = telemetry_profile(torch, tmp, card)
        laps.lap('device profile')
        over = telemetry_overhead(torch, comb, tmp, card)
        laps.lap('overhead')
        end = telemetry_endpoint(torch, comb, card)
        laps.lap('endpoint')
    print(f'telemetry wall time by step (host clock, {cpu_model()}): {laps.line()}', flush=True)
    return {'k1_paths': {'telemetry_profile': prof['k1_launches'], 'telemetry_overhead': over['k1_launches'],
                         'telemetry_endpoint': end['k1_launches']},
            'k2_paths': {'telemetry_profile': prof['k2_launches']}}  # fmt: skip


def modes_flagship(torch, prog, card: str) -> dict:
    """The flagship at ``FLAGSHIP_SAMPLES`` samples through each forced mode
    on the card. The forced ``mode='pallas'`` call (K1's count reset just
    before, read just after) must launch K1; its first ``MODES_REF_SAMPLES``
    rows equal the reference interpreter, and every other mode's call, none
    of which launches K1, equals it on every row. Each mode's ``fn_int`` is
    timed with CUDA events, and scan's host wall beside it."""
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import MODES, DaisExecutor

    data = np.random.default_rng(20261018).uniform(-8, 8, (FLAGSHIP_SAMPLES, prog.n_in))
    exs = {m: DaisExecutor(prog, mode=m) for m in MODES}
    assert {m: ex.mode for m, ex in exs.items()} == {m: m for m in MODES}
    cuda_backend.reset_counts()
    y = exs['pallas'](data)
    torch.cuda.synchronize()
    launches = cuda_backend.launches
    assert launches > 0, "flagship: the forced mode='pallas' call never launched K1"
    reference_equal(prog, data[:MODES_REF_SAMPLES], y[:MODES_REF_SAMPLES])
    x = exs['pallas'].int_inputs(data)
    times, host = {}, {}
    for m in ('unroll', 'scan', 'level'):
        cuda_backend.reset_counts()
        assert np.array_equal(exs[m](data), y), f"flagship: mode='{m}' differs from K1"
        assert cuda_backend.launches == 0, f"flagship: mode='{m}' launched K1"
    for m, reps in (('pallas', 20), ('unroll', 5), ('scan', 3), ('level', 5)):
        times[m] = cuda_ms(lambda ex=exs[m]: ex.fn_int(x), reps=reps)
    t0 = time.perf_counter()
    exs['scan'].fn_int(x)
    host['scan'] = time.perf_counter() - t0  # the host-side switch issues each step's launches
    torch.cuda.synchronize()
    host['scan_sync'] = time.perf_counter() - t0
    print(f"[{card}] modes, flagship ({prog.n_ops} ops, {FLAGSHIP_SAMPLES} samples, int32): "
          f"{', '.join(f'{m} {ms:.4f} ms' for m, ms in times.items())} (CUDA events, median); scan's host-side "
          f"switch issues one call's launches in {host['scan']:.4f} s of host clock ({host['scan_sync']:.4f} s to its "
          f"end); the forced pallas call launched K1 {launches} times, its first {MODES_REF_SAMPLES} rows equal to the "
          f"reference interpreter and every row to unroll, scan and level", flush=True)  # fmt: skip
    return {'k1_launches': launches, 'ms': times}


def modes_corpus(torch, card: str) -> int:
    """The ``MODES_CORPUS`` synth programs (narrow and wide, every family) in
    every mode on the card, as built and with ``force_i64=True`` (a narrow
    program then runs K1's int64 instantiation), each equal to the
    reference interpreter on ``MODES_CORPUS_SAMPLES`` samples. Returns K1's
    launches, counted around the checked calls."""
    from da4ml_tpu_torch.ir.synth import random_inputs, random_program
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.reference import run_program
    from da4ml_tpu_torch.runtime.torch_backend import MODES, DaisExecutor

    launches, runs, i64_k1 = 0, 0, 0
    for seed, n_ops, wide in MODES_CORPUS:
        rng = np.random.default_rng(seed)
        prog = random_program(rng, n_ops=n_ops, n_in=6, n_out=5, wide=wide)
        data = random_inputs(rng, prog, MODES_CORPUS_SAMPLES)
        want = run_program(prog, data)
        for force_i64 in (None, True):
            for m in MODES:
                ex = DaisExecutor(prog, force_i64=force_i64, mode=m)
                assert ex.use_i64 == (wide or bool(force_i64))
                cuda_backend.reset_counts()
                got = ex(data)
                torch.cuda.synchronize()
                n = cuda_backend.launches
                assert (n > 0) == (m == 'pallas'), f'corpus seed {seed}: mode={m} launched K1 {n} times'
                assert np.array_equal(got, want), (f'corpus seed {seed} (wide {wide}, force_i64 {force_i64}): '
                                                   f'mode={m} differs from the reference interpreter')  # fmt: skip
                launches += n
                runs += 1
                i64_k1 += m == 'pallas' and bool(force_i64) and not wide
    print(f'[{card}] modes, synth corpus: {len(MODES_CORPUS)} programs ({sum(w for *_, w in MODES_CORPUS)} wide) x '
          f'{len(MODES)} modes x (as built, force_i64=True) = {runs} runs of {MODES_CORPUS_SAMPLES} samples, each '
          f'equal to the reference interpreter; {i64_k1} narrow programs through K1\'s int64 instantiation; K1 launched '
          f'{launches} times', flush=True)  # fmt: skip
    return launches


def once_ms(torch, fn):
    """One call of ``fn`` timed with CUDA events: (its output, milliseconds).
    For a mode too slow to time more than once, on the call whose output is
    checked."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def modes_config5(torch, prog, card: str) -> dict:
    """Config 5 at ``MODES_CONFIG5_SAMPLES`` samples in unroll, scan and
    pallas on the card: the forced pallas call (K1's count reset just
    before, read just after) equal to the reference interpreter on its first
    ``MODES_CONFIG5_REF_SAMPLES`` rows; K1's integer output equal to unroll's
    and scan's on every row, each of those timed on that one call, K1 over
    10."""
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    data = np.random.default_rng(20261019).uniform(-8, 8, (MODES_CONFIG5_SAMPLES, prog.n_in))
    exs = {m: DaisExecutor(prog, mode=m) for m in ('pallas', 'unroll', 'scan')}
    cuda_backend.reset_counts()
    y = exs['pallas'](data)
    torch.cuda.synchronize()
    launches = cuda_backend.launches
    assert launches > 0, "config 5: the forced mode='pallas' call never launched K1"
    reference_equal(prog, data[:MODES_CONFIG5_REF_SAMPLES], y[:MODES_CONFIG5_REF_SAMPLES])
    x = exs['pallas'].int_inputs(data)
    y_int = exs['pallas'].fn_int(x)
    assert np.array_equal(exs['pallas'].float_outputs_on(y_int).cpu().numpy(), y)
    times = {'pallas': cuda_ms(lambda: exs['pallas'].fn_int(x), reps=10)}
    for m in ('unroll', 'scan'):
        out, times[m] = once_ms(torch, lambda ex=exs[m]: ex.fn_int(x))
        assert torch.equal(out, y_int), f"config 5: mode='{m}' differs from K1"
    print(f"[{card}] modes, config 5 ({prog.n_ops} ops, {MODES_CONFIG5_SAMPLES} samples): "
          f"{', '.join(f'{m} {ms:.4f} ms' for m, ms in times.items())} (CUDA events; pallas the median of 10, the "
          f"others one call); the forced pallas call launched K1 {launches} times, equal to the reference interpreter "
          f"on the first {MODES_CONFIG5_REF_SAMPLES} rows, K1 equal to unroll and scan on every row", flush=True)  # fmt: skip
    return {'k1_launches': launches, 'ms': times}


def modes_twin(torch, twin, wide, card: str) -> dict:
    """The int64 config-5 twin (19436 ops, under ``UNROLL_LIMIT``: its
    22424 ops are those of its seven-stage pipeline) in unroll and pallas at
    ``MODES_TWIN_SAMPLES`` samples: the forced pallas call (K1's count reset
    just before, read just after) equal to unroll on every row and to the
    reference interpreter on the first ``MODES_TWIN_REF_SAMPLES``, both
    timed; then ``mode='unroll'`` refusing the 256x256 conv front end, a
    program over ``UNROLL_LIMIT`` ops, with the reference's message."""
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    data = np.random.default_rng(20261021).uniform(-8, 8, (MODES_TWIN_SAMPLES, twin.n_in))
    exs = {m: DaisExecutor(twin, mode=m) for m in ('pallas', 'unroll')}
    assert exs['unroll'].dtype == torch.int64
    cuda_backend.reset_counts()
    y = exs['pallas'](data)
    torch.cuda.synchronize()
    launches = cuda_backend.launches
    assert launches > 0, "twin: the forced mode='pallas' call never launched K1"
    reference_equal(twin, data[:MODES_TWIN_REF_SAMPLES], y[:MODES_TWIN_REF_SAMPLES])
    x = exs['pallas'].int_inputs(data)
    y_int = exs['pallas'].fn_int(x)
    assert np.array_equal(exs['pallas'].float_outputs_on(y_int).cpu().numpy(), y)
    times = {'pallas': cuda_ms(lambda: exs['pallas'].fn_int(x), reps=5)}
    out, times['unroll'] = once_ms(torch, lambda: exs['unroll'].fn_int(x))
    assert torch.equal(out, y_int), "twin: mode='unroll' differs from K1"
    assert wide.n_ops > DaisExecutor.UNROLL_LIMIT, wide.n_ops
    try:
        DaisExecutor(wide, mode='unroll')
    except ValueError as e:
        message = str(e)
    else:
        raise AssertionError(f"mode='unroll' ran the {wide.n_ops}-op conv front end")
    assert message == (f"mode='unroll' refuses a {wide.n_ops}-op program (compile time grows with program size; "
                       f"UNROLL_LIMIT={DaisExecutor.UNROLL_LIMIT}). Use mode='level'."), message  # fmt: skip
    print(f"[{card}] modes, twin ({twin.n_ops} ops, int64, {MODES_TWIN_SAMPLES} samples): "
          f"{', '.join(f'{m} {ms:.4f} ms' for m, ms in times.items())} (CUDA events; pallas the median of 5, unroll "
          f"one call); the forced pallas call launched K1 {launches} times, equal to the reference interpreter on the "
          f"first {MODES_TWIN_REF_SAMPLES} rows, K1 equal to unroll on every row; the conv front end "
          f"({wide.n_ops} ops) refused by unroll: {message}",
          flush=True)  # fmt: skip
    return {'k1_launches': launches, 'ms': times}


def run_modes(torch, comb, config5_prog, twin_prog, wide_prog, card: str) -> dict:
    """The executor-modes phase: ``modes_flagship``, ``modes_corpus``,
    ``modes_config5`` and ``modes_twin`` (with the conv front end
    ``wide_prog``). Prints the phase's wall time by step; returns K1's
    checked launches by path."""
    from da4ml_tpu_torch.ir.dais_binary import decode

    laps = Laps()
    flag = modes_flagship(torch, decode(comb.to_binary()), card)
    laps.lap('flagship')
    corpus = modes_corpus(torch, card)
    laps.lap('corpus')
    model = modes_config5(torch, config5_prog, card)
    laps.lap('config 5')
    twin = modes_twin(torch, twin_prog, wide_prog, card)
    laps.lap('twin')
    print(f'executor modes wall time by step (host clock, {cpu_model()}): {laps.line()}', flush=True)
    return {'k1_paths': {'modes_flagship': flag['k1_launches'], 'modes_corpus': corpus,
                         'modes_config5': model['k1_launches'], 'modes_twin': twin['k1_launches']},
            'ms': {'flagship': flag['ms'], 'config5': model['ms']}}  # fmt: skip


def phase_samples(seed: int, n: int, n_in: int) -> np.ndarray:
    """The first ``n`` rows an earlier phase drew with
    ``default_rng(seed).uniform(-8, 8, (rows, n_in))``: the generator fills
    row by row, so they are its first ``n`` rows whatever its ``rows``."""
    return np.random.default_rng(seed).uniform(-8, 8, (n, n_in))


def auto_counts() -> tuple[float, float]:
    """``run.autotune`` and ``run.mode_cache_hit`` as the metrics hold them."""
    from da4ml_tpu_torch import telemetry

    snap = telemetry.metrics_snapshot()
    return tuple(snap.get(k, {}).get('value', 0.0) for k in ('run.autotune', 'run.mode_cache_hit'))


def auto_race(torch, label: str, build, data, card: str, full_ms: dict | None = None, held=None) -> dict:
    """One program's ``mode='auto'`` on the card: ``build()`` constructs its
    executor, racing (K1's count reset just before, read just after the
    race and the full-size call; each K1 call of the race recorded and its
    output held to K1's plain version on the race batch, so every counted
    launch is checked); the decision file read back; a second
    construction answered from memory and a third, the in-process decisions
    cleared, from the file; each skipped candidate whose bound is at most
    ``AUTO_TIMED_BOUND_S`` timed once at the race batch, above its bound
    and slower than the winner; ``full_ms``, phase 17's full-size times,
    beside the bounds; the winner on ``data`` equal to the reference
    interpreter (or to ``held``, an earlier phase's output on the same
    ``data`` that it held to the reference interpreter) and timed, K1
    forced beside it where it lost. Prints one line; returns the main
    path's K1 launches and the decision."""
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime import torch_backend as tb

    race_calls = []
    launch_k1 = cuda_backend.DaisKernel.__call__

    def recorded(kernel, x):
        y = launch_k1(kernel, x)
        race_calls.append((x, y))
        return y

    c0 = auto_counts()
    cuda_backend.reset_counts()
    cuda_backend.DaisKernel.__call__ = recorded
    t0 = time.perf_counter()
    try:
        ex = build()
        torch.cuda.synchronize()
    finally:
        cuda_backend.DaisKernel.__call__ = launch_k1
    race_s = time.perf_counter() - t0
    launches = cuda_backend.launches
    # every K1 call of the race, its warm-up and timed calls, held to K1's
    # plain version on the race batch before its launches count
    assert race_calls, f'{label}: the race did not call K1'
    for xr, yr in race_calls:
        assert torch.equal(yr, ex.plain(xr)), f'{label}: a K1 call of the race differs from its plain version'
    del race_calls
    prog, digest = ex.prog, ex._digest()
    blob = json.loads((Path(tb._mode_cache_dir()) / f'{digest}.cuda.json').read_text())
    assert blob['mode'] == ex.mode and blob['platform'] == 'cuda', (label, blob)
    assert auto_counts() == (c0[0] + 1, c0[1]), f'{label}: the construction did not race once'
    candidates = ex._candidates()
    measured = [m for m in candidates if f'{m}_samples_per_s' in blob]
    skipped = {m: blob[f'{m}_skipped_bound_s'] for m in candidates if f'{m}_skipped_bound_s' in blob}
    assert set(measured) | set(skipped) == set(candidates) and 'pallas' in measured, (label, blob)

    def rebuild():
        return tb.DaisExecutor(prog, autotune_min_ops=ex._autotune_min_ops)

    assert rebuild().mode == ex.mode and auto_counts() == (c0[0] + 1, c0[1] + 1), f'{label}: not answered from memory'
    tb._MODE_DECISIONS.clear()
    assert rebuild().mode == ex.mode and auto_counts() == (c0[0] + 1, c0[1] + 2), f'{label}: not answered from the file'

    batch = blob['batch']
    x_race = ex._race_batch()
    win_s = batch / blob[f'{ex.mode}_samples_per_s']
    at_batch = {}
    for m, bound_s in skipped.items():
        if bound_s > AUTO_TIMED_BOUND_S:
            continue
        plan = ex._build_plan(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan(x_race)
        torch.cuda.synchronize()
        at_batch[m] = time.perf_counter() - t0
        assert bound_s <= at_batch[m], f'{label}: {m} took {at_batch[m]} s at the race batch, under its bound {bound_s}'
        assert at_batch[m] > win_s, f'{label}: the skipped {m} ({at_batch[m]} s) beats the winner ({win_s} s)'
    del x_race

    cuda_backend.reset_counts()
    y = ex(data)
    torch.cuda.synchronize()
    launches += cuda_backend.launches
    if held is None:
        reference_equal(prog, data, y)
    else:
        assert np.array_equal(y, held), f'{label}: the winner differs from the output held to the reference interpreter'
    x = ex.int_inputs(data)
    times = {ex.mode: cuda_ms(lambda: ex.fn_int(x), reps=5)}
    if ex.mode != 'pallas':
        k1 = tb.DaisExecutor(prog, mode='pallas')
        assert torch.equal(k1.fn_int(x), ex.fn_int(x)), f'{label}: K1 differs from the winner'
        times['pallas'] = cuda_ms(lambda: k1.fn_int(x), reps=5)
    del x
    full = ''
    if full_ms:
        for m, bound_s in skipped.items():
            if m in full_ms:
                assert bound_s < full_ms[m] / 1e3, f'{label}: {m} at full size {full_ms[m]} ms, under its bound'
        full = ('; phase 17 at full size: ' + ', '.join(f'{m} {full_ms[m]:.4f} ms (bound {skipped[m] * 1e3:.4f} ms)'
                                                       for m in skipped if m in full_ms))  # fmt: skip
    built = ', '.join(f"{m} build {blob[f'{m}_compile_s']:.4f} s, {blob[f'{m}_samples_per_s']:.1f} samples/s"
                      for m in measured)  # fmt: skip
    skips = ', '.join(f'{m} (bound {b:.6f} s' + (f', one call {at_batch[m]:.6f} s)' if m in at_batch else ', not timed)')
                      for m, b in skipped.items()) or 'none'  # fmt: skip
    print(f"[{card}] auto, {label} ({prog.n_ops} ops, {prog.n_in} inputs; race batch {batch} rows, launch floor "
          f"{blob['launch_floor_s'] * 1e6:.3f} us): candidates {', '.join(candidates)}; {built}; skipped {skips}; "
          f"winner {ex.mode}; race {race_s:.3f} s (host clock); a second construction from memory, a third from the "
          f"file; at {len(data)} samples {', '.join(f'{m} {ms:.4f} ms' for m, ms in times.items())} (CUDA events), "
          f"equal to the reference interpreter; K1 launched {launches} times{full}", flush=True)  # fmt: skip
    return {'k1_launches': launches, 'mode': ex.mode, 'race_s': race_s, 'prog': prog,
            'min_ops': ex._autotune_min_ops}  # fmt: skip


def auto_child(path: str) -> int:
    """The child of the ``mode='auto'`` phase: each program of ``path`` (an
    ``.npz`` of DAIS binaries, ``min_ops`` the ``autotune_min_ops`` of each)
    constructed with ``mode='auto'``, the race replaced by a failure, so
    each answer must come from the decision files. Prints the modes as one
    JSON line."""
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.runtime import torch_backend as tb

    def no_race(self, digest, platform):
        raise AssertionError(f'the child raced {self.prog.n_ops} ops: no decision for {digest}@{platform}')

    tb.DaisExecutor._autotune = no_race
    blob = np.load(path)
    min_ops = json.loads(str(blob['min_ops']))
    modes = {name: tb.DaisExecutor(decode(blob[name]), autotune_min_ops=min_ops[name]).mode for name in min_ops}
    print(json.dumps(modes))
    return 0


def run_auto(torch, comb, config5_prog, block, wide_prog, card: str, full_ms: dict, held: dict) -> dict:
    """Phase 18, ``mode='auto'`` on the card (``DA4ML_RUN_MODE`` unset for
    the phase): ``auto_race`` on the flagship (``FLAGSHIP_SAMPLES``), config 5
    (``MODES_CONFIG5_SAMPLES``), the transformer block's fused program
    (``fused_executor_for_binaries``, ``FUSION_SAMPLES``) and the wide conv
    front end (``WIDE_CONV_SAMPLES``), the flagship, config 5 and the wide
    conv on the samples of phases 5, 9 and 11, whose outputs (``held``) those
    phases held to the reference interpreter; a synth program under
    ``AUTOTUNE_MIN_OPS`` ops taking K1 with no race; then a child process
    answered from the same decision files. Prints the phase's wall time by
    step; returns the K1 launches by path."""
    from da4ml_tpu_torch import telemetry
    from da4ml_tpu_torch.ir.dais_binary import decode, encode
    from da4ml_tpu_torch.ir.synth import random_inputs, random_program
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime import torch_backend as tb

    pinned = {k: os.environ.pop(k) for k in PINNED_ENV if k in os.environ}
    metrics_were_on = telemetry.metrics_on()
    telemetry.enable(metrics=True)
    laps, races, paths = Laps(), {}, {}
    try:
        flag = decode(comb.to_binary())
        races['flagship'] = auto_race(torch, 'flagship', lambda: tb.DaisExecutor(flag),
                                      phase_samples(20260729, FLAGSHIP_SAMPLES, flag.n_in), card, full_ms['flagship'],
                                      held['flagship'])  # fmt: skip
        laps.lap('flagship')
        races['config5'] = auto_race(torch, 'config 5', lambda: tb.DaisExecutor(config5_prog),
                                     phase_samples(20261018, MODES_CONFIG5_SAMPLES, config5_prog.n_in), card,
                                     full_ms['config5'], held['config5'][:MODES_CONFIG5_SAMPLES])  # fmt: skip
        laps.lap('config 5')
        binaries = [st.to_binary() for st in block.stages]
        races['fused_block'] = auto_race(torch, 'transformer block, fused', lambda: tb.fused_executor_for_binaries(binaries),
                                         np.random.default_rng(20261022).uniform(-4, 4, (FUSION_SAMPLES, block.shape[0])),
                                         card)  # fmt: skip
        laps.lap('fused block')
        races['wide_conv'] = auto_race(torch, 'wide conv', lambda: tb.DaisExecutor(wide_prog),
                                       phase_samples(20261020, WIDE_CONV_SAMPLES, wide_prog.n_in), card,
                                       held=held['wide_conv'])  # fmt: skip
        laps.lap('wide conv')
        assert races['wide_conv']['race_s'] < 60, f"the wide conv's race took {races['wide_conv']['race_s']} s"

        synth = random_program(np.random.default_rng(20261023), n_ops=AUTO_SYNTH_OPS, n_in=8, n_out=6)
        assert synth.n_ops <= tb.DaisExecutor.AUTOTUNE_MIN_OPS
        c0, n_files = auto_counts(), len(list(Path(tb._mode_cache_dir()).glob('*.json')))
        data = random_inputs(np.random.default_rng(20261024), synth, AUTO_SYNTH_SAMPLES)
        cuda_backend.reset_counts()
        ex = tb.DaisExecutor(synth)
        y = ex(data)
        torch.cuda.synchronize()
        paths['auto_synth'] = cuda_backend.launches
        assert ex.mode == 'pallas' and paths['auto_synth'] > 0, (ex.mode, paths['auto_synth'])
        assert auto_counts() == c0 and len(list(Path(tb._mode_cache_dir()).glob('*.json'))) == n_files, 'the synth raced'
        reference_equal(synth, data, y)
        print(f'[{card}] auto, synth ({synth.n_ops} ops, at most AUTOTUNE_MIN_OPS = {tb.DaisExecutor.AUTOTUNE_MIN_OPS}): '
              f'the static answer {ex.mode} with no race, K1 launched {paths["auto_synth"]} times, {AUTO_SYNTH_SAMPLES} '
              f'samples equal to the reference interpreter', flush=True)  # fmt: skip
        laps.lap('synth')

        with tempfile.TemporaryDirectory(prefix='chip_smoke_auto_') as d:
            f = Path(d) / 'progs.npz'
            np.savez(f, min_ops=json.dumps({k: r['min_ops'] for k, r in races.items()}),
                     **{k: encode(r['prog']) for k, r in races.items()})  # fmt: skip
            root = Path(__file__).resolve().parent
            env = {**os.environ, 'PYTHONPATH': os.pathsep.join(p for p in (str(root), os.environ.get('PYTHONPATH', '')) if p)}
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, str(root / 'chip_smoke.py'), '--auto-child', str(f)], env=env,
                                 capture_output=True, text=True, timeout=600)  # fmt: skip
            child_s = time.perf_counter() - t0
        assert out.returncode == 0, f'the auto child failed:\n{out.stderr[-4000:]}'
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got == {k: r['mode'] for k, r in races.items()}, (got, {k: r['mode'] for k, r in races.items()})
        print(f'[{card}] auto, child process: {got}, each answered from the decision files with no race, in '
              f'{child_s:.3f} s (host clock)', flush=True)  # fmt: skip
        laps.lap('child')
    finally:
        os.environ.update(pinned)
        if not metrics_were_on:
            telemetry.disable()
    print(f"mode='auto' wall time by step (host clock, {cpu_model()}): {laps.line()}", flush=True)
    paths.update({f'auto_{k}': r['k1_launches'] for k, r in races.items()})
    return {'k1_paths': paths}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    from da4ml_tpu_torch import native
    from da4ml_tpu_torch.cmvm import fused_cse, solve_torch_many
    from da4ml_tpu_torch.cmvm import torch_search as ts
    from da4ml_tpu_torch.entry import flagship_comb
    from da4ml_tpu_torch.ir.dais_binary import decode
    from da4ml_tpu_torch.ir.synth import random_program
    from da4ml_tpu_torch.native import build as native_build
    from da4ml_tpu_torch.runtime import cuda_backend
    from da4ml_tpu_torch.runtime.reference import run_program
    from da4ml_tpu_torch.runtime.torch_backend import DaisExecutor

    # mode='auto' decisions in a fresh directory, inherited by every child;
    # K1 for 'auto' in every phase but the mode='auto' phase
    decisions = tempfile.TemporaryDirectory(prefix='chip_smoke_decisions_')
    os.environ['DA4ML_TORCH_CACHE'] = decisions.name
    os.environ.update(PINNED_ENV)
    t_start = time.perf_counter()
    phases = Laps()
    card = card_line()
    print(card, flush=True)
    print(f'host: {cpu_model()}, {os.cpu_count()} cores', flush=True)

    # phase 1: nvcc builds K1, K2 and K2's phase-timing build, and g++ the
    # native host library, one process each, all started together; phase 2:
    # then the host solves the flagship (timed alone: the builds would share
    # its cores)
    builds: dict[str, float] = {}
    build_err: list[BaseException] = []

    def _build(name, build):
        t0 = time.perf_counter()
        try:
            build()
        except BaseException as e:  # re-raised on the main thread below
            build_err.append(e)
        builds[name] = time.perf_counter() - t0

    jobs = (('dais_exec', cuda_backend.build), ('fused_cse', fused_cse.build), ('fused_cse phases', fused_cse.build_phases),
            ('native', native_build.build))  # fmt: skip
    threads = [threading.Thread(target=_build, args=a) for a in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if build_err:
        raise build_err[0]
    for name, log in (('dais_exec', cuda_backend.build_log), ('fused_cse', fused_cse.build_log)):
        print(f'build {name}: {builds[name]:.3f} s (nvcc, sm_90a)')
        print_ptxas(log)
    k1_regs = k1_ptxas(cuda_backend.build_log)
    assert len(k1_regs) == 8, f'ptxas reported K1 instantiations {sorted(k1_regs)}'
    for (itemsize, glob, hi), info in sorted(k1_regs.items()):
        print(f'K1 int{8 * itemsize} {"global" if glob else "shared"}-memory {24 if hi else 16}-bit-field '
              f'instantiation: {info}')  # fmt: skip
        assert glob or info['spill_stores'] == info['spill_loads'] == 0, f'K1 int{8 * itemsize} spills: {info}'
    print(f"build fused_cse phases: {builds['fused_cse phases']:.3f} s (nvcc, sm_90a, -DFUSED_CSE_PHASES)")
    k2_regs = k2_ptxas(fused_cse.build_log)
    assert len(k2_regs) == 2 * len(fused_cse.CACHE_DEPTHS), f'ptxas reported K2 instantiations {sorted(k2_regs)}'
    print(f'build native: {builds["native"]:.3f} s ({gxx_version()}, {" ".join(native_build.CXX_FLAGS)}) '
          f'-> {native_build.lib_path()}', flush=True)  # fmt: skip
    assert native.load_lib() is not None, f'the native library did not load: {native.load_error()}'
    assert native.has_solver() and native.has_emit()
    phases.lap('builds')

    # phase 20's twin steps start now, beside the phases before it: the
    # command line's g++ build of the twin's emulator is the run's longest step
    cli_tmp = tempfile.TemporaryDirectory(prefix='chip_smoke_cli_')
    chain = CliTwinChain(torch, Path(cli_tmp.name))

    # phase 2: the flagship through each host solver; 'cpu' spawns its worker
    # pool while the native library is loaded in this process
    host_s, host_comb, native_calls = {}, {}, {'solve_native': 0}
    for backend, workers in (('cpu', os.cpu_count() or 1), ('cpp', 0), ('auto', 0)):
        with Patched({(native, 'solve_native'): counted(native_calls, 'solve_native')}):
            t0 = time.perf_counter()
            host_comb[backend] = flagship_comb(backend=backend, n_workers=workers)
            host_s[backend] = time.perf_counter() - t0
        if backend == 'cpu':
            assert native_calls['solve_native'] == 0, "backend='cpu' ran the native solver"
    assert native_calls['solve_native'] == 2 * 3, "'cpp' and 'auto' must solve each layer natively"
    comb = host_comb['cpu']
    for backend in ('cpp', 'auto'):
        assert np.array_equal(host_comb[backend].to_binary(), comb.to_binary()), f'{backend!r} differs from cpu'
    solve_s = host_s['cpu']
    print(f"solve: host CMVM (host clock, {cpu_model()}): 'cpu' {host_s['cpu']:.3f} s ({os.cpu_count()} spawned "
          f"workers), 'cpp' {host_s['cpp']:.3f} s (OpenMP's default thread count), 'auto' {host_s['auto']:.3f} s "
          f"(resolved to 'cpp'); programs byte-identical; cost {comb.cost}", flush=True)  # fmt: skip
    phases.lap('host solves')

    # phase 3: K1 corpus, kernel vs plain version on the card
    check_corpus(torch, DaisExecutor, cuda_backend, run_program, k1_regs)
    phases.lap('K1 corpus')

    # phase 4: K2's main path — the flagship through the device search, its
    # wall time on the host clock with no stage timer inside
    pmax0 = ts.search_stats['pmax_host_fallbacks']
    nat = dict.fromkeys(('decompose_batch', 'emit_batch'), 0)
    emit_calls: list = []  # replayed by the OpenMP phase
    native_counts = {(native, k): counted(nat, k, keep=emit_calls if k == 'emit_batch' else None) for k in nat}
    with RungRecorder(ts, fused_cse) as flag_rungs, Patched(native_counts):
        fused_cse.reset_counts()
        t0 = time.perf_counter()
        comb_dev = flagship_comb(backend='torch')
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        k2_launches = fused_cse.launches
    pmax_routes = ts.search_stats['pmax_host_fallbacks'] - pmax0
    classes = sorted({(s.P, s.O, s.B, s.topk, s.R_in) for _, s in flag_rungs.calls})
    print(f'device search: flagship solved in {dev_s:.3f} s on the card (host solve {solve_s:.3f} s); '
          f'{len(flag_rungs.calls)} rung calls in {len(classes)} classes (P, O, B, K, R_in) {classes}; K2 launched '
          f'{k2_launches} times; init_cache calls {flag_rungs.init_cache_calls}; PMAX host routes {pmax_routes}; '
          f'native decompose_batch calls {nat["decompose_batch"]}, emit_batch calls {nat["emit_batch"]}',
          flush=True)  # fmt: skip
    assert k2_launches == len(flag_rungs.calls) > 0, 'K2 must launch once per rung call of the device search'
    assert flag_rungs.init_cache_calls == 0, 'the device search built a score cache outside K2'
    assert nat['decompose_batch'] > 0 and nat['emit_batch'] > 0, 'the device search skipped the native host side'
    assert pmax_routes == 0, f'{pmax_routes} flagship lanes went to the host solver'
    assert np.array_equal(comb_dev.to_binary(), comb.to_binary()), 'device-solved flagship differs from the host-solved'
    prog = decode(comb_dev.to_binary())
    print(f'device search: program byte-identical to the host solve ({prog.n_ops} ops, cost {comb_dev.cost})')
    # the same search again (another device string is its own cache key, so
    # it traces anew), every stage timed: rung calls by stage, and the host
    # side; then once more with the Python host side
    for label, dev_key, py_host in (('native host side', 'cuda', False), ('Python host side', 'cuda:0', True)):
        clock, clock_s = host_clock(ts, native)
        py = Patched({(native, 'has_emit'): lambda real: (lambda: False)} if py_host else {})
        # emission in series, so that the host's stages add up
        with RungRecorder(ts, fused_cse, stages=True) as staged, clock, py, environ(DA4ML_JAX_ASYNC_EMIT='0'):
            fused_cse.reset_counts()
            t0 = time.perf_counter()
            comb_staged = flagship_comb(backend='torch', device=dev_key)
            torch.cuda.synchronize()
            staged_s = time.perf_counter() - t0
        assert fused_cse.launches == len(staged.calls) == len(flag_rungs.calls) and staged.init_cache_calls == 0
        assert np.array_equal(comb_staged.to_binary(), comb.to_binary()), f'the staged device search differs ({label})'
        rung_s = staged.total
        stages = ', '.join(f'{k} {v:.4f} s' for k, v in staged.seconds.items())
        other_s = clock_s['solve'] - rung_s - clock_s['decomposition'] - clock_s['emission']
        print(f'device search by stage, {label} ({staged_s:.3f} s, the timers synchronizing the device, emission in '
              f'series): rung calls '
              f'{rung_s:.4f} s ({stages}); host: tracing {staged_s - clock_s["solve"]:.4f} s, decomposition '
              f'{clock_s["decomposition"]:.4f} s, emission {clock_s["emission"]:.4f} s, rung ladder and argmin '
              f'{other_s:.4f} s', flush=True)  # fmt: skip

    phases.lap('device search')

    # phase 5: K1's main path at 2^20 samples, on the device-solved program
    dais = run_dais_flagship(torch, comb_dev, card, k1_regs)
    flagship_y = dais.pop('y')  # held to the reference interpreter; phase 18 reads it
    phases.lap('K1 flagship')

    # phase 6: K2 corpus — the flagship's rungs (timed, phases of each) and
    # random trit lanes
    rows = [check_rung(torch, ts, fused_cse, inp, spec, f'flagship {k}', phases=True)
            for k, (inp, spec) in enumerate(flag_rungs.calls)]  # fmt: skip
    rng = np.random.default_rng(20261016)
    # the last class's slices (P = 2048 over a cluster of 16) exceed the 227 KB
    # of shared memory a block can have, so K2 keeps them in global memory
    synth = [(64, 8, 4, -1, -1, 16), (128, 32, 6, 3, 8, 32), (256, 32, 6, -1, -1, 32), (256, 8, 2, 2, -1, 128),
             (512, 8, 4, -1, -1, 64), (1024, 64, 4, -1, -1, 16), (2048, 8, 4, -1, -1, 16)]  # fmt: skip
    for P, O, B, adder, carry, n_rows in synth:
        spec = ts._KernelSpec(P, O, B, adder, carry, R_in=n_rows, topk=8 if P <= 256 else 16)
        rows.append(check_rung(torch, ts, fused_cse, random_rung(rng, P, O, B, n_rows), spec,
                               f'random P{P} O{O} B{B} a{adder} c{carry}', phases=P == 2048))  # fmt: skip
    shapes = {}
    for r in rows:
        key = (r['P'], r['O'], r['B'], r['K'])
        if key not in shapes:
            shapes[key] = g = k2_geometry(torch, fused_cse, *key, k2_regs)
            print(f"K2 class P {key[0]} O {key[1]} B {key[2]} K {key[3]}: cluster {g['C']} x {g['threads']} threads, "
                  f"{g['placement']} slice {g['slice_bytes']} B, dynamic shared memory {g['dynamic_smem']} B per block, "
                  f"{g['active_clusters']} clusters at once; {g['registers']} registers, "
                  f"{g['stack']} B stack frame")  # fmt: skip
            assert g['active_clusters'] > 0, key
        r['placement'] = shapes[key]['placement']
    for r in rows:
        print(f"K2 rung {r['name']}: N {r['N']} P {r['P']} O {r['O']} B {r['B']} K {r['K']}, {r['iters']} iterations "
              f"(at most {r['max_iters']} a lane), {r['chains']} i == j chains: equal, K2 {r['ms']:.4f} ms "
              f"({r['ms'] * 1e3 / max(r['max_iters'], 1):.2f} us per iteration of its longest lane), "
              f"plain {r['plain_ms']:.2f} ms")  # fmt: skip
        if 'phases' in r:
            print(f"  [{card}] K2 phases, lane 0, clock64 cycles: {phase_line(r['phases'])}")
    empty = [k2_empty_launch_ms(torch, ts, fused_cse, *flag_rungs.calls[k]) for k in (0, len(flag_rungs.calls) - 1)]
    host_us = [k2_launch_host_us(torch, ts, fused_cse, *flag_rungs.calls[k]) for k in (0, len(flag_rungs.calls) - 1)]
    print(f'[{card}] K2 launch with every lane at cur == P (the fixed cost of a launch): '
          f'{", ".join(f"{ms:.4f} ms" for ms in empty)} on the card, {", ".join(f"{us:.2f} us" for us in host_us)} '
          f'of host time per launch call (100 back to back) (the first and the last flagship rung)')  # fmt: skip
    assert any(r['K'] == 16 for r in rows) and any(r['chains'] for r in rows)
    assert {r['placement'] for r in rows} == {'shared', 'global'}, 'K2 must run both placements'
    flag_rows = [r for r in rows if r['name'].startswith('flagship')]
    k2_ms, k2_plain = sum(r['ms'] for r in flag_rows), sum(r['plain_ms'] for r in flag_rows)
    k2_bound = rung_bound_ms(flag_rows)
    ops_ms, bytes_ms = sum(r['ops_ms'] for r in flag_rows), sum(r['bytes_ms'] for r in flag_rows)
    part = {k: sum(r[k] for r in flag_rows) for k in ('int_build_ms', 'fp_build_ms', 'int_loop_ms', 'fp_loop_ms')}
    print(f'[{card}] fused_cse: {k2_ms:.4f} ms over the flagship\'s {len(flag_rows)} rungs '
          f'({sum(r["iters"] for r in flag_rows)} iterations), cache build included; plain version {k2_plain:.2f} ms; '
          f'bound {k2_bound:.6f} ms by {"operations" if ops_ms >= bytes_ms else "bytes"} '
          f'(operations {ops_ms:.6f} ms: int32 cache build {part["int_build_ms"]:.6f} ms and recount '
          f'{part["int_loop_ms"]:.6f} ms, fp32 cache build {part["fp_build_ms"]:.6f} ms and scores, merge and argmax '
          f'{part["fp_loop_ms"]:.6f} ms; HBM {bytes_ms:.6f} ms); K2 {k2_ms / k2_bound:.0f}x the bound')  # fmt: skip
    phases.lap('K2 corpus')

    # phase 7: the wider six-bit layers of bench.py through the device search
    wrng = np.random.default_rng(20260729)
    kernels = []
    for ni, no in WIDE_LAYERS:
        mag = wrng.integers(0, 2**6, (ni, no)).astype(np.float64)
        kernels.append(mag * wrng.choice([-1.0, 1.0], (ni, no)))
    native_sols, native_s = [], []
    for k in kernels:
        t0 = time.perf_counter()
        native_sols.append(native.solve_native(k))
        native_s.append(time.perf_counter() - t0)
    with RungRecorder(ts, fused_cse) as wide_rungs:
        t0 = time.perf_counter()
        sols = solve_torch_many(kernels)
        torch.cuda.synchronize()
        wide_s = time.perf_counter() - t0
    for k, s, n in zip(kernels, sols, native_sols):
        assert np.array_equal(np.asarray(s.kernel, np.float64), k), f'wide layer {k.shape} is not exact'
        assert same_solution(s, n), f'wide layer {k.shape}: the device search differs from the native solver'
    print(f'wider layers {WIDE_LAYERS}: {wide_s:.3f} s on the card, exact and op for op equal to the native solver '
          f'({", ".join(f"{t:.3f}" for t in native_s)} s a layer, host clock, {cpu_model()}); cost '
          f'{[float(s.cost) for s in sols]} (total {sum(float(s.cost) for s in sols)}), {len(wide_rungs.calls)} rungs, '
          f'largest P {max(s.P for _, s in wide_rungs.calls)}')  # fmt: skip
    phases.lap('wider layers')

    # phase 8: the native library's OpenMP runtime beside CUDA torch's
    openmp_check(torch, native, native_build, comb_dev, emit_calls, kernels)
    phases.lap('OpenMP')

    # phases 9-11: the traced workloads through the port's tracer, K2 and K1:
    # the config-5 model, the fusion workloads, the 256x256 conv front end
    model = run_config5(torch, ts, fused_cse, native, card, k1_regs)
    phases.lap('config 5')
    fusion = run_fusion(torch, ts, fused_cse, card, k1_regs)
    phases.lap('fusion')
    wide_conv = run_wide_conv(torch, card, k1_regs)
    phases.lap('wide conv')

    # phases 12-13: the conversion on the card at the integer types' edges;
    # bench.py's pipeline model through the four pipeline modes
    wide = DaisExecutor(random_program(np.random.default_rng(5), n_ops=400, n_in=8, n_out=6, wide=True))
    assert wide.dtype == torch.int64
    conversion_edges(torch, DaisExecutor(prog), wide)
    pipeline_launches = run_pipeline_model(torch, card)
    phases.lap('conversion edges and pipeline model')

    # phase 14: the firmware path — RTL codegen of the flagship and of the
    # config-5 twin traced from an nn.Module through K2, K1 on both, the
    # netlist simulators, the codegen precondition
    firmware = run_firmware(torch, ts, fused_cse, comb_dev, card)
    phases.lap('firmware')

    # phase 15: the quality search — the flagship, the quality corpus and
    # config 5 through the device beam and K2's fork rungs, convert --quality
    quality = run_quality(torch, ts, fused_cse, card, Path(cli_tmp.name), model['cost'])
    phases.lap('quality search')

    # phase 16: telemetry — convert --trace in a child, the device profile of
    # K1 and K2 in another, the instrumentation's overhead, the live endpoint
    tel = run_telemetry(torch, comb_dev, card)
    phases.lap('telemetry')

    # phase 17: the executor's forced modes — the flagship, a synth corpus
    # (force_i64 too) and config 5 through unroll, scan, level and K1 as
    # mode='pallas', each held to the others and the reference interpreter;
    # the int64 twin in unroll and K1; unroll refuses the conv front end
    modes = run_modes(torch, comb_dev, model['prog'], firmware['twin']['prog'], wide_conv['prog'], card)
    phases.lap('executor modes')

    # phase 18: mode='auto' — the race on the flagship, config 5, the fused
    # transformer block and the conv front end, the decision cache in memory,
    # in its files and in a child; the static answer on a small program
    auto = run_auto(torch, comb_dev, model['prog'], fusion['pipes']['transformer_block'], wide_conv['prog'], card,
                    modes['ms'], {'flagship': flagship_y, 'config5': model['ref_y'], 'wide_conv': wide_conv['y']})  # fmt: skip
    phases.lap("mode='auto'")

    # phase 19: the resident rung ladder against the host-state one — host-
    # state re-solves of what phases 4, 15, 7 and 9 solved resident, the
    # fetched digits against the host replay, config 5's memory, the spill
    held = {'flagship': comb_dev, 'flagship_k2': k2_launches,
            'search': flagship_comb(backend='torch', device='cuda', quality='search'),
            'search_k2': quality['k2_paths']['quality_flagship_search'], 'wide_kernels': kernels, 'wide': sols,
            'wide_k2': len(wide_rungs.calls), 'config5': model['binary'], 'config5_k2': model['k2_launches']}  # fmt: skip
    run_resident(torch, ts, fused_cse, card, held)
    phases.lap('resident ladder')

    # phase 20: the command line — convert to HLS projects (K2, K1 against
    # the g++ emulator), verify (conformance in every mode), lint-opcodes
    cli = run_cli(torch, ts, fused_cse, comb_dev, card, Path(cli_tmp.name), chain)
    cli_tmp.cleanup()
    decisions.cleanup()
    phases.lap('cli')

    # phase 21: the port imported nothing of JAX
    assert 'jax' not in sys.modules and 'da4ml_tpu' not in sys.modules, 'jax or da4ml_tpu was imported'

    k1_paths = {'flagship': dais['launches'], 'config5': model['k1_launches'], 'fusion': fusion['k1_launches'],
                'wide_conv': wide_conv['k1_launches'],
                **{f'fusion_{mode}': n for mode, n in fusion['k1_modes'].items()},
                **{f'pipeline_model_{mode}': n for mode, n in pipeline_launches.items()},
                'firmware_flagship': firmware['flagship']['k1_launches'], 'firmware_twin': firmware['twin']['k1_launches'],
                'cli_flagship': cli['flagship']['k1_launches'], 'cli_twin': cli['twin']['k1_launches'],
                **quality['k1_paths'], **tel['k1_paths'], **modes['k1_paths'], **auto['k1_paths']}  # fmt: skip
    k2_paths = {'flagship': k2_launches, 'config5': model['k2_launches'], 'fusion': fusion['k2_launches'],
                'firmware_twin': firmware['twin']['k2_launches'], 'cli_twin': cli['twin']['k2_launches'],
                **quality['k2_paths'], **tel['k2_paths']}  # fmt: skip
    k1_err = max(dais['max_abs_err'], firmware['flagship']['k1_err'], firmware['twin']['k1_err'], quality['k1_err'])
    kernels_line = [
        {**dais, 'max_abs_err': k1_err, 'launches': sum(k1_paths.values()), 'launches_by_path': k1_paths},
        {
            'name': 'fused_cse',
            'route': 'cuda',
            'source': 'da4ml_tpu_torch/csrc/fused_cse.cu',
            'replaces': 'da4ml_tpu/cmvm/fused_cse.py:108',
            'launches': sum(k2_paths.values()),
            'launches_by_path': k2_paths,
            'max_abs_err': max(max(r['max_abs_err'] for r in rows), model['k2_err'], fusion['k2_err'],
                               firmware['twin']['k2_err'], cli['twin']['k2_err'], quality['k2_err']),
            'ms': k2_ms,
            'plain_ms': k2_plain,
            'bound_ms': k2_bound,
            'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
            'library_ms': None,
        },
    ]
    print(f'chip_smoke: wall time by phase (host clock, {cpu_model()}): {phases.line()}')
    print(f'chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s (host clock)')
    print(json.dumps({'kernels': kernels_line}))
    print(card)
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0), 'count': torch.cuda.device_count()}
    print(json.dumps({'ok': True, 'device': device}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--profile-child']:
        sys.exit(profile_child(Path(sys.argv[2])))
    if sys.argv[1:2] == ['--auto-child']:
        sys.exit(auto_child(sys.argv[2]))
    sys.exit(main())
