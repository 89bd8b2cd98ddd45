#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ctranslate2_tpu_torch``) on one card.

Run from the repository root, with no arguments, on a machine with one
NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON object per line:

1. card: the card's name and power limit, the torch/CUDA versions, and the
   seconds to build the six CUDA sources from ``ctranslate2_tpu_torch/csrc``
   (and, at the same time, the native host core with g++);
   before it a ``ptxas`` line with the registers, spills and static shared
   memory of every kernel of the two wgmma sources, the decode source, the
   W4 source and the norm source (``PTXAS_REPORT``).
2. Translator main path: the full-width Transformer-base model (6+6 layers,
   d_model 512, ffn 2048, 8 heads, 32,000 words; random weights from seed
   7), ``Translator(..., compute_type="int8").translate_batch`` on batches
   of 64 sentences of 20-30 tokens, beam 2, exactly 32 target tokens; then
   one call with ``CT2TPU_BEAM_CHAIN=0`` (the fused-gather beam reorder).
   Every pre-norm layer's residual add runs inside the next norm's launch,
   and every norm before int8 linears quantizes for them in that launch
   (the fused forms of ``csrc/fused_norm.cu``). On every main path the
   profiler counts the launches a call and a decode step (the whole call
   against the call cut to its first token), with the busy share, once with
   the fused forms and once with ``CT2TPU_PALLAS_NORMS=0`` (``launches_*``
   lines).
3. Generator main path: the Llama-3-8B geometry (``LLAMA``: 32 layers,
   d_model 4096, 32 query / 8 KV heads of 128, ffn 14336, 128,256 words,
   rotary base 500000, RMSNorm, SwiGLU) fabricated as int8 payloads from
   seeds, ``Generator(..., compute_type="int8").generate_batch`` on 4
   prompts of 2,049 tokens, ``include_prompt_in_result=False``, greedy,
   exactly 64 new tokens, with ``CT2TPU_KV_CACHE=int8``: the prefill of
   2,048 takes the flash kernel, every decode step the int8-KV decode
   kernel, every RMSNorm the norm kernel (with the residual add and the
   int8 quantization for the QKV, the GLU pair and the projection), every
   linear W8A8. One call with ``CT2TPU_PALLAS_NORMS=0`` for its decode ms
   a step, one more with the float16 KV cache. Then the flash kernel against
   ``CT2TPU_FLASH=0`` and the decode kernel against
   ``CT2TPU_DECODE_KERNEL=0`` at full depth (a prefill and one step): a
   random-weight model of this depth amplifies any rounding difference under
   W8A8, so the switch-off run is fed the kernel run's int8 activations at
   every linear (``ReplayQuantized`` on ``ops.linear.int8_activations``,
   which every int8 activation passes, the norm kernel's included). Each
   layer's attention then gets the kernel run's inputs,
   and its output is compared where the output projection quantizes it: at
   most one int8 step apart, on at most ``FED_STEP_SHARE`` of the entries.
4. AWQ Generator main path: the same widths at a quarter of the depth
   (``AWQ_LAYERS``) in AutoAWQ's GEMM layout
   (group 128, zero points; float16 embeddings and projection), fabricated
   in memory; ``Generator(...).generate_batch`` with the card's defaults
   (float16 activations, packed W4) and ``CT2TPU_KV_CACHE=int8``, the same
   prompts and lengths: every layer linear goes through ``matmul_w4p``; then
   one call with ``CT2TPU_W4_PACKED=0`` (``matmul_w4a16``). The launch
   counts are checked against the expected ones, and no W4 plain version may
   run on the card.
   The W4 plan's path of every launch is logged too (``w4_paths``): the
   prefill's four products must take the wgmma path, the decode steps
   split-K.
   On every main path the launch counters are zeroed just before and read
   just after; each kernel of the path must have launched, and the shapes
   it was called with are logged over the same calls.
5. kernels: each of the nine kernels at every shape a main path gave it
   (the two folded W4 forms, which ``linear()`` never dispatches, at their
   counterpart's shapes), against its plain PyTorch version on the same
   inputs, with its time, the plain version's, the one library call's
   where there is one and the bound (W8A8 and the two dispatched W4 forms
   also with their plan from ``w8a8_plan`` / ``w4_plan`` and the time of
   each path the plan did not pick, held to the same tolerance, the folded
   W4 forms too, ``matmul_w4p_fold`` with the time of its zero-point term;
   causal flash also with its query tiles in launch order; the decode kernel
   also with its ``decode_plan``); the W4 crossover rows (``w4_crossover``:
   every W4 path of the four forms at M = 65-8,192 over the four Llama
   (K, N)); timed
   rows at Gemma-2-9B's attention widths (``GEMMA2_ATTENTION``: flash at
   q [4, 16, 2048, 256] causal against SDPA, decode over a [4, 8, 2176, 256]
   cache), not summed into the totals; then small shapes for every feature
   the paths do not use (flash at head dim 256 and at 32, 80, 96, 160 and
   192, zero-padded to the kernel's 64 / 128 / 256; the decode kernel at
   head dims 72, 200 and 256 with windows, a window of 1 and rows of length
   0; the norm and its fused forms at widths off a multiple of 8). The norm
   runs in each form a main path gives it (``NORM_FORMS``; the AWQ path's
   timed, not summed), with the time of the launches the form replaces
   (eager add + norm kernel + ``quantize_per_row`` in one CUDA graph); a
   W8A8 split-K call is profiled for memsets (none: its workspace is kept
   per stream; the ``w8a8_memsets`` line, right after the card phase, at
   the int8 Generator's four decode shapes). Tolerances: W8A8 bit-equal,
   gather equal, ``FLASH_TOL``, ``DECODE_TOL``, ``NORM_F32_TOL`` / one ulp of the half
   type (the fused forms also: the sum bit-equal to the plain add, q and
   scale bit-equal to ``quantize_per_row`` of the kernel's own y, within
   one int8 step of the plain sequence on at most ``FED_STEP_SHARE`` of the
   entries), ``w4_error_bound`` for the W4 products.
6. float16 Translator run, float32 chain/chain-off pair, Translator card
   against CPU (as before).
7. Generator A/B at the same widths and 2 layers, no activation
   quantization: flash against ``CT2TPU_FLASH=0`` and the int8-KV decode
   kernel against ``CT2TPU_DECODE_KERNEL=0``. In float32 the first-step
   log-probs must agree within ``LOGPROB_TOL``; in float16 within
   ``OWN_ERROR_FACTOR`` times float16's own error on the same path (its
   plain run against the float32 plain run); the first 8 tokens must be the
   same on every row in both. Then the card against the port on the CPU
   (float32, prompts of 513 with ``flash_attention=True``): within
   ``LOGPROB_TOL`` with the float KV cache; with the int8 KV cache (a cached
   vector at a rounding tie may land one step apart) within
   ``INT8_KV_LOGPROB_TOL``.
8. AWQ checks at 2 layers of the same AWQ weights: the card in float32 (the
   W4 kernels' FMA path) against the port on the CPU (the plain versions),
   packed and unpacked, within ``LOGPROB_TOL``; the card in float16 (the
   ``mma`` path), each W4 kernel against its plain version patched in its
   place, within ``OWN_ERROR_FACTOR`` times float16's own error and with
   the same first 8 tokens.

9. The teacher-forced entry points and random sampling, each with the
   launch counters zeroed just before and read just after, every kernel's
   call shapes logged, and every kernel plain version's calls on the card
   counted (there must be none): ``score_translator`` (the int8
   Translator's ``score_batch`` on a phase-2 batch against its own
   translations, right after phase 2); ``score_generator`` (the int8
   Llama's ``score_batch`` on 4 prompts of 2,049, 2,055 teacher-forced
   positions a row: causal flash with per-row lengths, the W8A8
   projection at M 8,220 and N 128,256; then ``forward_batch(
   return_log_probs=True)``, whose gathered log-probs must equal the
   scores) and ``sampling`` (that Llama's ``generate_batch`` with top-k 50
   and temperature 0.8 twice with one seed and once with another, 32 new
   tokens, int8 KV cache; beam 2 with ``sampling_topk=10`` on the int8
   Translator, chain mask on and off, which as in the JAX package gives
   the argmax beam; ``sample_tokens`` drawing
   ``SAMPLE_ROWS`` times from one distribution, every word within
   ``FREQ_SIGMAS`` standard errors and none outside the nucleus), both
   after phase 3 on its model; ``encoder`` (``Encoder.forward_batch`` at
   bert-base-uncased's widths, ``BERT``, fabricated from seeds, in int8
   and float16: 32 sequences of up to 128 tokens, then 8 of up to 512 with
   ``flash_attention=True``, the flash kernel non-causal at head dim 64),
   after phase 4. In the kernel phase, every shape these paths gave a
   kernel that no main path did is held against its plain version and
   timed in rows of its own (``"summed": false``), not in the totals.
   Then, at ``AB_LAYERS`` layers in float32, the card against the port on
   the CPU (``teacher_forced_card_vs_cpu``): ``score_batch`` and
   ``forward_batch`` on 2 prompts of 513 with flash forced on, the
   Encoder's hidden states and pooler, within ``LOGPROB_TOL``; a sampled
   ``generate_batch`` token-identical with both sides fed the same noise.

10. The host decode loops (each with the launch counters zeroed just
   before and read just after, the kernels' call shapes logged and their
   plain versions' calls on the card counted; none allowed):
   ``host_loop_translator`` (the int8 Translator on a phase-2 batch,
   ``OPTS``, after ``score_translator``: one timed call each of
   ``return_attention`` with ``replace_unknowns``, ``coverage_penalty=0.2``,
   ``prefix_bias_beta=0.5`` on 4-token target prefixes,
   ``return_logits_vocab``, ``return_alternatives`` with 4 hypotheses on
   3-token prefixes (the first ``HOST_ALT_SENTENCES`` sentences), ``use_vmap`` with a ``vmap.txt`` written into the
   model directory (``VMAP_TARGETS`` words of a pool of ``VMAP_POOL`` a
   source token: about 3,700 candidates a sentence, a 4,096-wide
   projection), and a ``callback`` at beam 1, beside the device loop's
   calls; the attention, logits and callback calls give the device loop's
   hypotheses under ``compare_chain``'s rule, every host beam call launches
   the gather kernel); ``host_loop_generator`` (the int8 Llama with the
   int8 KV cache after ``sampling``: a callback's greedy call against the
   device loop's, token-identical with one callback a token, the decode ms
   a step of both; every step's vocabulary logits for 8 tokens; a static
   prompt of 2,048 tokens before 4 prompts of 64, two calls timed to their
   first token, the second with no flash launch; the alternatives of one
   prompt) and ``host_loop_card_vs_cpu`` (at ``AB_LAYERS`` layers, float32:
   every option on the card against the port on the CPU, identical tokens
   and callbacks, scores, attention and logits within ``LOGPROB_TOL``; the
   static prompt's tokens equal to the prompt prepended's).

11. The architecture features at four families' published widths and half
   their depths (``ARCH_DEPTH_DIVISOR``; ``architectures_*``: Gemma-2-9B,
   MPT-7B, Falcon-7B, Flan-T5-large, int8 payloads from seeds) and
   ``architectures_card_vs_cpu`` at 2 layers.

12. The file and streaming helpers and the speech models, each call with
   the launch counters zeroed just before and read just after, the kernels'
   call shapes logged and their plain versions' calls on the card counted
   (none allowed): ``file_helpers_translator`` (after
   ``host_loop_translator``: ``translate_file`` of the four phase-2
   batches at ``max_batch_size`` 64, its lines equal to ``translate_batch``'s
   hypotheses, with scores equal to its scores, and with read windows of 64
   (at least ``FILE_SAME_SHARE`` of the lines equal); ``score_file`` on the
   pair, its means within 1e-6 of ``score_batch``'s; ``translate_iterable``
   equal to the batch calls; target tok/s beside ``translate_batch``'s);
   ``file_helpers_generator`` (after ``host_loop_generator``, the int8 Llama
   with the int8 KV cache: ``generate_tokens`` on one 2,049-token prompt,
   64 new tokens equal to ``generate_batch``'s, its time to the first token
   and ms a step; ``generate_iterable`` over the 4 prompts;
   ``async_generate_tokens``); ``whisper`` (``WHISPER_LARGE_V3``,
   openai/whisper-large-v3's widths at ``WHISPER_LAYERS`` + ``WHISPER_LAYERS``
   layers, int8 with the int8 KV cache: ``encode``
   of 4 x 30 s; ``generate`` at beam 5 with timestamps, max_length 448; a
   32-token ``<|startofprev|>`` prompt with the no-speech probability and a
   greedy ``<|notimestamps|>`` call, max_length ``WHISPER_SHORT_LENGTH``;
   ``detect_language``; ``align`` of 4 texts of 32 tokens at 3,000 frames;
   then ``encode`` built with ``flash_attention=True``, fed the first
   encode's int8 activations (``ReplayQuantized``): only the attention
   outputs may differ, by one int8 step on at most ``FED_STEP_SHARE``);
   ``wav2vec2`` (``WAV2VEC2_LARGE``, 8 x 20 s of 16 kHz audio, 999 frames,
   then with flash, fed likewise); ``w2v_bert`` (``W2V_BERT_2``, 8 x 1,000
   frames); then, after ``architectures_card_vs_cpu``,
   ``speech_card_vs_cpu`` at ``AB_LAYERS`` layers in float32: Whisper's
   tokens identical on three calls, its encoder output (flash too),
   no-speech, language and alignment probabilities and the two encoders'
   logits (flash on and off) within ``LOGPROB_TOL`` of the port on the CPU,
   the alignments identical. The kernel phase benches every shape these
   paths gave a kernel that no earlier path did, in rows of their own
   (``"summed": false``).

13. Serving, each run with the launch counters zeroed just before
   and read just after, the kernels' call shapes logged and their plain
   versions' calls on the card counted (none allowed):
   ``serving_translator`` (after ``file_helpers_translator``:
   ``BufferedTranslationWrapper`` and ``translation_scheduler`` on the
   four phase-2 batches submitted one sentence at a time, at least
   ``FILE_SAME_SHARE`` of the hypotheses equal to ``translate_batch``'s,
   target tok/s beside its) and ``residency_translator``
   (``unload_model(to_cpu=True)`` / ``load_model()`` timed, the allocated
   memory falling by at least the int8 payloads, the same hypotheses after
   the reload, a reload without a host copy raising);
   ``serving_generator`` (after ``file_helpers_generator``, the int8 Llama
   with the int8 KV cache
   behind ``ContinuousBatcher``: ``SERVE_SLOTS``
   slots of ``SERVE_CAPACITY``, ``SERVE_STEPS`` steps a block;
   ``SERVE_REQUESTS`` requests submitted at once, a quarter of the prompts
   2,048 long (flash in the admit prefill), the rest 16-512, replies 4-16
   or 64-128 tokens; at pipeline depth 1 and 2: tokens/s, time to first
   token and latency p50 / p95, slot occupancy, ms a block; the same
   requests run to completion in batches of 8 on the same engine; one
   profiled block: launches a step and the busy share; each request's
   first token and log-prob
   against a teacher-forced prefill of its prompt padded alike, within
   ``SERVE_FIRST_LOGPROB_TOL``), then ``residency_generator`` (as the
   Translator's, at least the 8.03 GB of int8 payloads freed);
   ``serving_card_vs_cpu`` (after ``host_loop_card_vs_cpu``, ``AB_LAYERS``
   layers in float32: the batcher on the card against the batcher on the
   CPU, float and int8 KV, every per-request option, sampling fed the same
   noise; tokens identical, scores within ``LOGPROB_TOL`` /
   ``INT8_KV_LOGPROB_TOL`` a token; a batcher and a ``generate_batch`` call
   at the same time on one model). The kernel phase holds the serving
   shapes against the plain versions in rows of their own
   (``serving_benches``, ``"summed": false``): the decode kernel over 8
   slots with lengths 0 to capacity - block, flash at the 1-row 2,048
   prefill, W8A8 and the norm at the decode M and at the smallest, median
   and largest padded prompt (every other W8A8 prefill shape held
   bit-equal, untimed).
14. Serving, part 2 (PR 17), each run's launch counters zeroed before and
   read after, no plain version on the card, one gather launch a beam
   step: ``continuous_translator`` (after ``residency_translator``: the
   int8 Transformer-base behind ``ContinuousTranslator``, ``CT_SLOTS``
   slots, the 256 phase-2 sentences at once, beam 2 and beam 1, exactly
   32 target tokens; target tok/s against ``translate_batch``'s, ms a
   block, launches a beam step, one profiled block on the model at
   ``HALF_LAYERS`` + ``HALF_LAYERS`` layers; at least
   ``FILE_SAME_SHARE`` of the hypotheses equal to ``translate_batch``'s,
   a parted one logged with its step and the two candidates' log-prob
   gap); ``serving_generator_beam`` (after ``serving_generator``: the
   int8 Llama behind ``ContinuousBatcher(beam_size=4)``, the first 16 of
   ``serving_traffic``, then greedy at depth 1; tok/s, first delivery and
   latency p50 / p95, ms a block, one profiled block on the Llama's first
   ``SIDE_LAYERS`` layers, the gather over the 4.8 GB slot cache a step
   against its bound); ``continuous_whisper``
   (after ``whisper``: 8 segments of 3,000 frames, 4 slots, beam 5, half
   with timestamp rules; segments/s, ms a block, the share equal to
   ``Whisper.generate``'s, well-formed timestamps);
   ``serving_beam_card_vs_cpu`` (after ``serving_card_vs_cpu``, 2 layers
   in float32: beam 2 serving of 6 Llama requests up to 513 tokens with
   a stop sequence and two hypotheses, float and int8 KV; the 2-layer
   ``ContinuousTranslator`` beam 2 with a target prefix) and
   ``continuous_whisper_card_vs_cpu`` (last: Whisper at 2 + 2 layers,
   beam 2, with and without timestamps). The kernel phase times the
   gather at the three slot-cache shapes and the W8A8 and norm shapes no
   earlier path gave (``serving_beam_benches``, ``"summed": false``).

15. The host core, ``host_core_*`` lines, the phase's seconds in
   ``host_core``: ``host_core_native`` (the native module, built by g++
   beside the kernels' nvcc in the card phase: its seconds, its file in
   the port's ``_build/``, its package-qualified name); after
   ``continuous_translator_spec``, ``host_core_cli`` (``cli.translate.main``
   in process on the four phase-2 batches, int8, beam 2, with
   ``--log_throughput`` and then ``--log_profiling``: its file equal to
   ``translate_file``'s line for line, its tok/s, the profiler's table),
   ``host_core_scheduler`` (``translation_scheduler`` on the native queue,
   each batch it formed equal to ``translate_batch`` on that batch) and
   ``host_core_replicas`` (``Translator(device_index=[0, 0])`` on the
   Translator's widths at ``HALF_LAYERS`` + ``HALF_LAYERS`` layers: a stream a
   replica, every hypothesis equal to one replica's, tok/s of one replica,
   of two workers on one and of two replicas, the busy share, one shared
   tree out and back; then the Translator's encoder as an ``Encoder`` of
   two replicas, its card tensors bit-equal to one replica's);
   ``host_core_load`` (right after the Llama is
   fabricated: written at ``MAIN_LAYERS`` into the work directory and
   loaded to the card through the native index over a map of model.bin and
   through the copying reader, each timed with this process's host memory
   over the load; the two trees bit-equal on the card).

16. Tensor parallelism (after ``host_core_load``, on its file):
   ``parallel_one_rank`` (an in-process NCCL group of one rank: the int8
   Translator on ``PAR_SENTENCES`` phase-2 sentences and the int8 Llama at
   ``MAIN_LAYERS`` with ``tensor_parallel=True`` bit-equal to the calls
   without it; the group destroyed after); ``parallel_nccl_probe`` (two
   ranks of one NCCL communicator on card 0: NCCL refuses them, the line
   says how); ``parallel_two_ranks`` (two child ranks of this script,
   ``--tp-rank``, on card 0 over gloo, started through
   ``parallel/launch.py``: the Translator and the full-width int8 Llama
   shards, their first-step log-probs fed this process's int8 activations
   (``ReplayShards``: a row-parallel linear takes its columns) within
   ``LOGPROB_TOL``; greedy on 2 x 2,049 (flash) and beam 2, a
   ``ContinuousBatcher`` led by rank 0, their int8 partings from this
   process's one-rank runs logged, not judged; the 2-layer Llama in float32
   on the model axis, tokens identical, and its 2 prompts split over a
   data axis of 2 (each rank runs one), tokens identical; ``PAR_SERVE``
   requests served through a ``ContinuousBatcher`` of ``PAR_SERVE`` slots
   on that axis, each data rank holding and decoding half of the slots:
   tokens identical to one rank's and each rank's slot cache half of one
   rank's bytes (``data_axis_slot_bytes``); a 4,096-token
   ring prefill over that axis, firing in both layers, tokens identical; the ring
   against the plain attention at ``FLASH_TOL["float16"]``; ms a decode
   step at 2 ranks against 1, the collectives' time from the port's scope
   profiler, which waits for the card's queued work before each scope,
   each rank's payload and peak memory). The kernel phase holds
   the shard shapes against the plain versions untimed
   (``parallel_benches``).

17. Conversion without JAX (``convert_and_run``, after ``card_vs_cpu``): in
   a subprocess where importing ``jax`` or ``ctranslate2_tpu`` raises, an
   OpenNMT-py checkpoint and a Marian ``.npz`` at ``CONVERT``'s widths (2
   layers, d_model 512, 8 heads) fabricated with torch and numpy and
   converted through the port's ``cli/convert.py`` (OpenNMT-py with
   ``--quantization int8``); the port's ``Translator`` on the card against
   the port on the CPU on both directories, beam 2 on
   ``CONVERT_SENTENCES`` sentences with the chain mask off: the float
   tokens identical, first-step log-probs within ``LOGPROB_TOL`` (the int8
   run fed the CPU's int8 activations); W8A8, the norm and the gather
   launched, no plain version on the card.

The rows the kernel phase does not sum into the totals (the W4 crossover,
Gemma-2-9B's attention and every later path's shapes) are held
against their plain versions untimed (``untimed()``; their times in the
lines are null): PERF.md records them from earlier runs. The main paths'
rows are timed.

The line before the last is ``{"kernels": [...]}`` (times are sums over
the ``launches`` counted on the main paths), the last
``{"ok": true, "device": {...}}``. The script exits non-zero, without
those lines, if CUDA is unavailable, any call raises or any check fails.
"""

import atexit
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
PEAK_HALF_FLOPS = 989e12  # H100 SXM dense f16/bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
BATCH = 64
BEAM = 2
MAX_DEC = 32
ITERS = 3
# The sources whose registers, shared memory and spills the card phase
# reports (nvcc -Xptxas -v).
PTXAS_REPORT = ("w8a8_gemm", "flash_attention", "decode_attention_int8", "w4_gemm",
                "fused_norm")
OPTS = dict(beam_size=BEAM, max_decoding_length=MAX_DEC,
            min_decoding_length=MAX_DEC, return_scores=True)
# Chain-off vs chain run: the share of identical hypotheses, and the largest
# difference of their normalized scores. In float16 the two attentions'
# other summation orders can part a near-tied beam (60/64 identical on the
# H100); float32 and int8 must be identical.
CHAIN_SAME_SHARE = {"int8": 1.0, "float16": 0.9, "float32": 1.0}
SCORE_TOL = 0.05
# Card against CPU, first decode step's log-probs, both sides summing floats
# in their own orders on the same inputs (int8: the same int8 activations).
LOGPROB_TOL = 1e-3
# Fed the same int8 activations upstream, a linear's input still differs
# between the card and the CPU by float32 rounding, which moves an entry at a
# half-step tie by one int8 step (2 in 65,536 at the worst linear on the
# H100 when the runs are left free).
QUANT_DIFF_SHARE = 1e-3
# Card against CPU with the int8 KV cache (float32, 2 layers): a cached
# vector at a rounding tie lands one int8 step apart (7.6e-3 on the H100;
# the int8 cache's own effect on these log-probs is 0.26).
INT8_KV_LOGPROB_TOL = 5e-2
# A float16 attention kernel against the plain float16 path on the same
# inputs, read after int8 quantization at the output projection: the share
# of one linear's entries that may land one step apart (on the H100 0.023
# for the flash kernel and 0.039 for the decode kernel at the worst layer).
FED_STEP_SHARE = 0.08
# Split-K W8A8 calls profiled for memsets (``w8a8_memset_check``), and the
# share of their kernels the profiler must have recorded.
W8A8_PROFILED_CALLS = 50
PROFILED_SHARE = 0.9
MODEL = dict(vocab_size=32000, num_layers=6, num_heads=8, d_model=512,
             d_ff=2048, seed=7)
# Its depth in ``host_core_replicas`` and ``continuous_translator``'s
# profiled block: the run's time limit.
HALF_LAYERS = MODEL["num_layers"] // 2
# The Generator's model: Llama-3-8B's geometry at full width and depth.
LLAMA = dict(layers=32, d_model=4096, heads=32, heads_kv=8, d_ff=14336,
             vocab=128256, rotary_base=500000.0)
# The main Generator's depth, shared by every phase that runs ``gen`` (the
# main path, beam and speculative serving, speculation, residency): half of
# Llama-3-8B's 32 layers, at its full widths. At 32 the whole script ran
# past its 1,200 s limit on a slower host (PERF.md section 4).
MAIN_LAYERS = LLAMA["layers"] // 2
GEN_BATCH = 4
# Gemma-2-9B's attention (google/gemma-2-9b config.json: num_attention_heads
# 16, num_key_value_heads 8, head_dim 256) at the Generator's batch.
GEMMA2_ATTENTION = dict(batch=4, heads=16, heads_kv=8, head_dim=256)
GEN_PROMPT = 2049  # the prefill is 2,048 long: the flash kernel's threshold
GEN_NEW = 64
# The profiled Generator calls' new tokens (fewer than GEN_NEW: their
# launches a step are the same, and the profiler's cost grows with the
# events it records, which the run's time limit bounds).
PROFILE_NEW = 8
AB_NEW = 8
AB_LAYERS = 2
CPU_PROMPT = 513
# Kernel against plain version on the card. float32: the sums run in another
# order. Half types: the plain version is computed in float32 from the same
# half inputs; the kernel rounds P to the half type before P.V and its
# output once more (bfloat16 has 8 bits of mantissa).
FLASH_TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
             "float16": dict(atol=2e-3, rtol=0.0),
             "bfloat16": dict(atol=1.6e-2, rtol=0.0)}
DECODE_TOL = dict(atol=1e-4, rtol=1e-4)
NORM_F32_TOL = dict(atol=1e-5, rtol=1e-5)
# Two correct runs that each carry a rounding error independently part by
# up to about 1.4 times that error (sqrt(2) for two independent errors of
# one size). Where a switch changes the summation order upstream of a
# rounding step (float16 activations), the two runs are held to this
# multiple of the rounding's own error, measured in the same run on the same
# inputs.
OWN_ERROR_FACTOR = 1.5
# The AWQ model: AutoAWQ's GEMM layout, group 128, the same geometry.
AWQ_GROUP = 128
AWQ_CPU_PROMPT = 129
# The crossover rows of ``w4_plan``: every path of the four W4 forms at
# these M over the four Llama (K, N), float16 (not summed: no main path
# runs the M between 4 and 8,192). ``W4_SPLITK_MAX_M`` and the folded
# forms' constants are set from them; the four (K, N) are the AWQ path's
# linears.
W4_CROSSOVER_MS = (65, 128, 256, 512, 1024, 2048, 8192)
W4_FORMS = (("matmul_w4p", True, False), ("matmul_w4p_fold", True, True),
            ("matmul_w4a16", False, False), ("matmul_w4a16_fold", False, True))
W4_CROSSOVER_KN = ((4096, 4096), (4096, 6144), (4096, 14336), (14336, 4096))
# The AWQ Generator's depth: a quarter of Llama-3-8B's 32 layers (the
# run's time limit: half since PR 16, a quarter since the beam serving
# phases of PR 17), at its full widths.
AWQ_LAYERS = LLAMA["layers"] // 4
# Expected launches of one AWQ generate_batch call (4 prompts of 2,049, 64
# new tokens): 5 W4 linears in each layer, for the prefill and each of the
# 64 steps; a decode-kernel launch a layer and step; 2 norms a layer and
# the output norm a forward pass.
AWQ_LAUNCHES_PER_CALL = {"w4": AWQ_LAYERS * 5 * (1 + GEN_NEW), "flash_attention": AWQ_LAYERS,
                         "decode_attention_int8": GEN_NEW * AWQ_LAYERS,
                         "fused_norm": (2 * AWQ_LAYERS + 1) * (1 + GEN_NEW),
                         "matmul_w8a8": 0}
# The Encoder's model: bert-base-uncased's published widths (its
# config.json: hidden_size 768, num_hidden_layers 12, num_attention_heads 12,
# intermediate_size 3072, vocab_size 30522, max_position_embeddings 512,
# type_vocab_size 2, hidden_act gelu, layer_norm_eps 1e-12; a tanh pooler),
# laid out as the JAX package's Transformers converter writes BERT, with
# random weights from seeds.
BERT = dict(layers=12, d_model=768, heads=12, d_ff=3072, vocab=30522,
            positions=512, types=2)
ENC_SHAPES = ((32, 128, False), (8, 512, True))  # (rows, longest, flash flag)
# Sampling: new tokens of each sampled Generator call, and the frequency
# check's draws (rows of one distribution over SAMPLE_VOCAB words).
SAMPLE_NEW = 32
SAMPLE_ROWS, SAMPLE_VOCAB = 100_000, 1000
SAMPLE_OPTS = dict(topk=50, topp=0.9, temperature=0.7)
FREQ_SIGMAS = 5.0
# The host decode loops: target-prefix tokens of the prefix-bias and the
# alternatives calls, alternatives a call, and the vocabulary map's rules
# (each source token proposes VMAP_TARGETS words of one pool of VMAP_POOL).
HOST_BIAS_PREFIX = 4
HOST_ALT_PREFIX = 3
HOST_ALT_HYPOTHESES = 4
# Sentences of the alternatives call: one ``decode_alternatives`` each (an
# interactive user asks for one sentence's), about 1 s a sentence on the
# card at Transformer-base's widths.
HOST_ALT_SENTENCES = 8
VMAP_POOL = 4000
VMAP_TARGETS = 400
# The architecture paths: each family's published config.json widths and
# depths (``source`` in each phase line), fabricated from seeds.
GEMMA2_9B = dict(layers=42, d_model=3584, heads=16, heads_kv=8, head_dim=256,
                 d_ff=14336, vocab=256000, window=4096, query_pre_attn_scalar=256,
                 final_softcap=30.0, rotary_base=10000.0, eps=1e-6)
GEMMA2_PROMPT = 8257  # prefilled 8,256: chunks 4,096 / 4,096 / 64; the rings wrap
GEMMA2_NEW = 32
# Ring on and off at full width (int8 weights and KV; the rings dequantized
# against the decode kernel with the window on linear caches, two float16
# attentions in other orders): every row's first tokens must agree (both
# rows' first 8 did on the H100).
GEMMA2_RING_SAME = 8
MPT_7B = dict(layers=32, d_model=4096, heads=32, d_ff=16384, vocab=50432, eps=1e-5)
MPT_BEAM_PROMPT = 64
MPT_BEAM_NEW = 16
FALCON_7B = dict(layers=32, d_model=4544, heads=71, d_ff=18176, vocab=65024,
                 rotary_base=10000.0, eps=1e-5)
FLAN_T5_LARGE = dict(layers=24, d_model=1024, heads=16, head_dim=64, d_ff=2816,
                     vocab=32128, buckets=32, max_distance=128, eps=1e-6)
T5_SOURCES = 16
T5_SOURCE_TOKENS = 1024
T5_TARGET_TOKENS = 32
# ``architectures_card_vs_cpu``: builder models and the Gemma-2 / Flan-T5
# layouts at these widths (4 heads of 64), ``AB_LAYERS`` layers; a window of
# 64 (a 256-slot ring), prompts of ARCH_AB_LONG past it.
ARCH_AB = dict(vocab_size=512, num_heads=4, d_model=256, d_ff=512)
# The architecture phases run their families at half their published depth
# (widths as published): the speech phases' time comes out of theirs, so
# the whole run stays inside its limit on a slow host.
ARCH_DEPTH_DIVISOR = 4  # a quarter of each family's depth: the run's time limit


def arch_depth(cfg):
    """``cfg`` cut to ``1 / ARCH_DEPTH_DIVISOR`` of its layers."""
    return dict(cfg, layers=cfg["layers"] // ARCH_DEPTH_DIVISOR)
ARCH_AB_WINDOW = 64
ARCH_AB_LONG = 300
ARCH_AB_NEW = 8
GEMMA2_AB = dict(GEMMA2_9B, d_model=256, heads=4, heads_kv=2, head_dim=64, d_ff=512,
                 vocab=512, window=ARCH_AB_WINDOW, query_pre_attn_scalar=64)
FLAN_T5_AB = dict(FLAN_T5_LARGE, d_model=256, heads=4, head_dim=64, d_ff=512, vocab=512)


STARTED = time.perf_counter()


def _json_safe(obj):
    """``obj`` with every NaN (an untimed row's time) as None."""
    if isinstance(obj, float) and math.isnan(obj):
        return None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def emit(obj):
    """Prints one JSON line; phase lines carry the script's elapsed seconds."""
    if "phase" in obj:
        obj = dict(obj, elapsed_s=round(time.perf_counter() - STARTED, 1))
    print(json.dumps(_json_safe(obj)), flush=True)


# Set by ``untimed()``: the benches hold each kernel against its plain
# version and time nothing.
_UNTIMED = False


@contextlib.contextmanager
def untimed():
    """The benches inside run every correctness check they make, but
    ``cuda_time_ms`` and ``host_us`` call their function once and return
    NaN (null in the lines): for the rows of shapes whose times earlier
    runs recorded (PERF.md section 6), which the run's time limit cannot
    afford to time again."""
    global _UNTIMED
    _UNTIMED = True
    try:
        yield
    finally:
        _UNTIMED = False


def free_card():
    """Frees what the last phase left: cyclic garbage first (a loaded model
    can sit in a reference cycle), then the allocator's cached blocks."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


class Checks:
    def __init__(self):
        self.failed = []

    def __call__(self, ok, what):
        if not ok:
            self.failed.append(what)
            emit({"check_failed": what})
        return ok


@contextlib.contextmanager
def patched(module, name, wrap):
    """Replaces ``module.name`` by ``wrap(original)`` for one block."""
    orig = getattr(module, name)
    setattr(module, name, wrap(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def chain_off():
    """Turns chain-mask beam attention off: the beam reorders its caches
    through the gather kernel."""
    os.environ["CT2TPU_BEAM_CHAIN"] = "0"
    try:
        yield
    finally:
        os.environ.pop("CT2TPU_BEAM_CHAIN")


# Guards the shape logs' and plain-call counters' increments: the worker
# threads of two replicas call the wrappers at once.
LOG_LOCK = threading.Lock()


def shape_log(counts, key):
    """A ``patched`` wrapper that counts the calls per ``key(*args)``."""
    def wrap(orig):
        def wrapped(*args, **kwargs):
            k = key(*args, **kwargs)
            with LOG_LOCK:
                counts[k] = counts.get(k, 0) + 1
            return orig(*args, **kwargs)
        return wrapped
    return wrap


def _dt(t):
    return str(t.dtype).split(".")[1]


# What identifies a call shape of each kernel's wrapper.
SHAPE_KEYS = {
    "matmul_w8a8": lambda q, wq, a, w: (q.shape[0], q.shape[1], wq.shape[0]),
    "gather_rows_fused": lambda arrays, rows: (
        tuple((tuple(a.shape), str(a.dtype)) for a in arrays), rows.shape[0]),
    "flash_attention": lambda q, k, v, **kw: (
        tuple(q.shape), k.shape[1], k.shape[2], _dt(q), bool(kw.get("causal")),
        kw.get("lengths") is not None, kw.get("window", 0),
        # ALiBi: its convention (positive positions); T5: (buckets, max
        # distance, bidirectional).
        None if kw.get("alibi_slopes") is None else bool(kw.get("alibi_positive")),
        None if kw.get("rel_bias_table") is None else (
            kw["rel_bias_table"].shape[0], kw.get("rel_max_distance", 0),
            bool(kw.get("rel_bidirectional", True)))),
    "decode_attention_int8": lambda q, k8, ks, v8, vs, lengths, **kw: (
        tuple(q.shape), k8.shape[1], k8.shape[2], _dt(q),
        kw.get("k_new8") is not None, kw.get("window", 0)),
    "fused_norm": lambda x, gamma, beta=None, **kw: (
        x.numel() // x.shape[-1], x.shape[-1], _dt(x), beta is not None,
        kw.get("residual") is not None, bool(kw.get("quantize")),
        kw.get("keep_sum", True), kw.get("keep_y", True)),
    "matmul_w4p": lambda x, w4p, gs, zs: (x.shape[0], x.shape[1], w4p.shape[1], _dt(x)),
    "matmul_w4a16": lambda x, w4, gs: (x.shape[0], x.shape[1], w4.shape[1], _dt(x)),
}


@contextlib.contextmanager
def kernel_shape_logs(logs):
    """Logs, per kernel, the call shapes its wrapper is given (where the
    model code looks the wrapper up) into ``logs[name][shape] += 1``."""
    import ctranslate2_tpu_torch.models.transformer as T
    import ctranslate2_tpu_torch.ops.linear as L
    import ctranslate2_tpu_torch.ops.norms as N

    homes = {"matmul_w8a8": L, "gather_rows_fused": T, "flash_attention": T,
             "decode_attention_int8": T, "fused_norm": N, "matmul_w4p": L,
             "matmul_w4a16": L}
    with contextlib.ExitStack() as stack:
        for name, module in homes.items():
            stack.enter_context(patched(
                module, name, shape_log(logs.setdefault(name, {}), SHAPE_KEYS[name])))
        yield logs


def check_logs_cover(counts, logs, logs_before, label, checks):
    """The shape logs must account for every counted launch."""
    for name, n in counts.items():
        logged = sum(logs.get(name, {}).values()) - logs_before.get(name, 0)
        checks(logged == n,
               f"{label}: the shape log of {name} covers every counted launch "
               f"({logged} logged, {n} counted)")


_CAPTURE_STREAM = None


def cuda_time_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls, after a warm-up.

    The calls are captured in a CUDA graph and the graph is timed with CUDA
    events: timing eager calls would measure the host's launch rate, which
    for kernels of tens of microseconds is slower than the card."""
    import torch

    if _UNTIMED:
        fn()
        return math.nan
    global _CAPTURE_STREAM
    if _CAPTURE_STREAM is None:
        _CAPTURE_STREAM = torch.cuda.Stream()
    stream = _CAPTURE_STREAM
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # the warm-up runs on the capture stream: per-stream state
        # (the W4 split-K counters) is then made outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls=200):
    """Host microseconds a call of ``fn()`` takes to enqueue its work: the
    Python, dispatch and launch cost that bounds a decode step, for work
    that the card finishes faster than the host enqueues it."""
    import torch

    fn()
    if _UNTIMED:
        return math.nan
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - start
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def ptxas_summary(log):
    """Per kernel entry of an ``-Xptxas -v`` log: its registers, spill
    stores and loads, and static shared memory, as one short string."""
    out = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = re.sub(r"_ZN\d+_GLOBAL__N__\w+?_\d+_\w+?_cu_\w{8}\d+", "", m.group(1))
            out[entry] = ""
        elif entry and ("registers" in line or "spill" in line):
            out[entry] += line.split(":", 1)[-1].strip() + "; "
    return out


def make_batch(vocab, seed):
    import numpy as np

    r = np.random.default_rng(1000 + seed)
    return [[vocab.to_token(int(t)) for t in r.integers(3, 31990, int(r.integers(20, 31)))]
            for _ in range(BATCH)]


def translate_run(translator, batches):
    """Timed translate_batch calls; returns (results, seconds, tokens)."""
    import torch

    results = []
    torch.cuda.synchronize()
    start = time.perf_counter()
    for b in batches:
        results.append(translator.translate_batch(b, **OPTS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    tokens = sum(len(r.hypotheses[0]) for res in results for r in res)
    return results, seconds, tokens


def compare_chain(chain, off):
    """Chain-mask results against chain-off results of the same batch: the
    identical hypotheses, the score differences among them (the summation
    order's own noise) and those of the sentences whose hypotheses parted."""
    same = [a.hypotheses == b.hypotheses for a, b in zip(chain, off)]
    diffs = [abs(a.scores[0] - b.scores[0]) for a, b in zip(chain, off)]
    return {"identical": sum(same), "sentences": len(same),
            "best_score_max_abs_diff": max(diffs),
            "identical_best_score_max_abs_diff": max(
                (d for d, s in zip(diffs, same) if s), default=None),
            "parted_best_score_abs_diff": [d for d, s in zip(diffs, same) if not s]}


def check_chain(cmp, label, checks):
    checks(cmp["identical"] >= CHAIN_SAME_SHARE[label] * cmp["sentences"]
           and cmp["best_score_max_abs_diff"] <= SCORE_TOL,
           f"{label}: chain-off hypotheses match the chain run's "
           f"({cmp['identical']}/{cmp['sentences']} identical, "
           f"best-score diff {cmp['best_score_max_abs_diff']})")


def profile_call(call, label):
    """One call of the entry point under torch.profiler: the device's busy
    time (sum of kernel times) against the call's wall time, and the
    kernels that took the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        # Kernels only: a CPU op issued from this thread carries its
        # kernels' device time too, and they are rows of their own.
        if getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    line = {"phase": f"profile_{label}", "wall_ms_profiled": wall_ms,
            "device_busy_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches_profiled": sum(r[1] for r in rows),
            "top_device_ms": [[name[:60], ms, n] for ms, n, name in rows[:8]]}
    emit(line)
    return line


def profile_launches(call, first_token_call, steps, label, full_steps=None):
    """``profile_call`` of a whole call and of the same call cut to its
    first token: the launches a call, and a decode step as the difference
    over the ``steps - 1`` steps the cut call leaves out; with the norm
    kernel's fused forms (the default) and with ``CT2TPU_PALLAS_NORMS=0``
    (the plain sequence: add, norm, quantization, each eager). With
    ``full_steps``, also the launches of a call of that many steps (the
    first token's plus the steps'). Returns {"fused" | "plain_norms": {...}}."""
    out = {}
    for arm, norms in (("fused", "1"), ("plain_norms", "0")):
        suffix = "" if arm == "fused" else "_plain_norms"
        with environ(CT2TPU_PALLAS_NORMS=norms):
            whole = profile_call(call, label + suffix)
            first = profile_call(first_token_call, f"{label}{suffix}_first_token")
        per_step = (whole["kernel_launches_profiled"]
                    - first["kernel_launches_profiled"]) / (steps - 1)
        out[arm] = {
            "launches_per_call": whole["kernel_launches_profiled"],
            "launches_per_decode_step": per_step,
            "device_busy_share": whole["device_busy_share"],
            "wall_ms_profiled": whole["wall_ms_profiled"]}
        if full_steps:
            out[arm][f"launches_per_call_of_{full_steps}_steps"] = (
                first["kernel_launches_profiled"] + (full_steps - 1) * per_step)
    emit({"phase": f"launches_{label}", **out})
    return out


def main_path(tt, model_dir, compute_type, batches, checks, label, logs):
    """Timed chain-on calls plus one chain-off call, with the launch
    counters zeroed before and read after, and each kernel's call shapes
    logged over the same calls."""
    import torch

    translator = tt.Translator(model_dir, compute_type=compute_type)
    translator.translate_batch(batches[0], **OPTS)  # warm-up, both paths
    with chain_off():
        translator.translate_batch(batches[0], **OPTS)

    logged_before = {name: sum(d.values()) for name, d in logs.items()}
    with kernel_shape_logs(logs):
        torch.cuda.reset_peak_memory_stats()
        tt.reset_launches()
        results, seconds, tokens = translate_run(translator, batches[1:1 + ITERS])
        chain_counts = tt.launch_counts()
        with chain_off():
            off, off_seconds, _ = translate_run(translator, batches[1:2])
        counts = tt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    first_token = dict(OPTS, max_decoding_length=1, min_decoding_length=1)
    launches = profile_launches(
        lambda: translator.translate_batch(batches[1], **OPTS),
        lambda: translator.translate_batch(batches[1], **first_token), MAX_DEC, label)

    cmp = compare_chain(results[0], off[0])
    lengths_ok = all(len(r.hypotheses[0]) == MAX_DEC for res in results for r in res)
    checks(lengths_ok, f"{label}: every hypothesis has {MAX_DEC} tokens")
    checks(counts["gather_rows_fused"] > chain_counts["gather_rows_fused"],
           f"{label}: the chain-off call launched the gather kernel")
    check_logs_cover(counts, logs, logged_before, label, checks)
    check_chain(cmp, label, checks)
    steps = (ITERS + 1) * MAX_DEC
    emit({"phase": f"main_{label}", "compute_type": translator.compute_type,
          "calls": ITERS, "sentences_per_call": BATCH, "beam": BEAM,
          "target_tokens": tokens, "seconds": seconds,
          "target_tokens_per_s": tokens / seconds,
          "chain_off_call_seconds": off_seconds,
          "launches_chain_calls": chain_counts,
          "launches_total": counts,
          "w8a8_launches_per_call": chain_counts["matmul_w8a8"] / ITERS,
          "fused_norm_launches_per_call": chain_counts["fused_norm"] / ITERS,
          "fused_norm_launches_per_decode_step": (
              counts["fused_norm"] - (ITERS + 1) * 13) / steps,
          "gather_launches_chain_off_call": counts["gather_rows_fused"]
          - chain_counts["gather_rows_fused"],
          "chain_off_vs_chain": cmp,
          "profiled_launches": launches,
          "peak_memory_bytes": peak})
    return counts


def chain_float32(tt, model_dir, batch, checks):
    """The chain/chain-off pair in float32 on the card at full width: a
    second witness that the two beam paths agree where float16's rounding
    cannot part near-tied beams."""
    translator = tt.Translator(model_dir, compute_type="float32")
    chain = translator.translate_batch(batch, **OPTS)
    with chain_off():
        off = translator.translate_batch(batch, **OPTS)
    cmp = compare_chain(chain, off)
    check_chain(cmp, "float32", checks)
    emit({"phase": "chain_float32", "chain_off_vs_chain": cmp})


def w8a8_other_plan(qm, M, K, N):
    """The plan of the path ``w8a8_plan`` does not pick for (M, K, N), where
    the other path takes the shape (None where it does not)."""
    chosen = qm.w8a8_plan(M, N, K)
    saved = qm.WGMMA_MIN_M
    qm.WGMMA_MIN_M = 1 << 40 if chosen.path == "wgmma" else 1
    try:
        other = qm.w8a8_plan(M, N, K)
    finally:
        qm.WGMMA_MIN_M = saved
    return other if other.path != chosen.path else None


def w8a8_memset_check(checks):
    """W8A8's split-K path at the int8 Generator's decode shapes (M = 4 at
    the four Llama (K, N), every one split), profiled over
    ``W8A8_PROFILED_CALLS`` calls after a warm-up: no memset, and no more
    than one kernel a call (the workspace is kept per stream, zeroed once).
    The profiler can drop a record of a window (19 of 20 kernels on the
    H100), so it must show at least ``PROFILED_SHARE`` of the calls' kernels
    for the count of memsets to stand. It runs before any other profiled
    phase; where the profiler shows fewer of the window's kernels and no
    memset (it dropped records), the window is taken again, ten times as
    long, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from ctranslate2_tpu_torch.kernels import quant_matmul as qm
    from ctranslate2_tpu_torch.kernels.quant_matmul import matmul_w8a8

    d, ff = LLAMA["d_model"], LLAMA["d_ff"]
    qkv = (LLAMA["heads"] + 2 * LLAMA["heads_kv"]) * d // LLAMA["heads"]
    g = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    for K, N in ((d, qkv), (d, d), (d, ff), (ff, d)):
        q = torch.randint(-128, 128, (GEN_BATCH, K), generator=g, device="cuda",
                          dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
        a_s = torch.rand(GEN_BATCH, generator=g, device="cuda") + 0.5
        w_s = torch.rand(N, generator=g, device="cuda") + 0.5
        plan = qm.w8a8_plan(GEN_BATCH, N, K)
        matmul_w8a8(q, wq, a_s, w_s)  # the stream's workspace is made here
        for window, calls in enumerate((W8A8_PROFILED_CALLS,)
                                       + (10 * W8A8_PROFILED_CALLS,) * 3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    matmul_w8a8(q, wq, a_s, w_s)
                torch.cuda.synchronize()
            events = {e.key: e.count for e in prof.key_averages()
                      if (getattr(e, "self_device_time_total", None)
                          or getattr(e, "self_cuda_time_total", 0)) > 0}
            kernels = sum(c for e, c in events.items() if "w8a8_splitk" in e)
            memsets = sum(c for e, c in events.items() if "memset" in e.lower())
            if memsets or kernels >= PROFILED_SHARE * calls:
                break
        checks(plan.splits > 1 and PROFILED_SHARE * calls <= kernels <= calls
               and memsets == 0,
               f"w8a8 split-K at {(GEN_BATCH, K, N)} ({plan.splits} splits): one "
               f"kernel a call and no memset over {calls} calls ({events})")
        out[f"M {GEN_BATCH} K {K} N {N}"] = {
            "splits": plan.splits, "calls": calls, "kernels": kernels, "memsets": memsets,
            "windows": window + 1, "host_us_per_call": host_us(lambda: matmul_w8a8(q, wq, a_s, w_s))}
    emit({"phase": "w8a8_memsets", "shapes": out})


def bench_w8a8(shapes, checks, **extra):
    """Kernel vs plain vs library at each (M, K, N), weighted by its
    launches on the main path; returns the sums over those launches. Each
    line also carries the plan (path, split count, tile) and the time of
    the path the plan did not pick, the evidence for the crossover;
    ``extra`` goes into each line."""
    import torch
    from ctranslate2_tpu_torch.kernels import quant_matmul as qm
    from ctranslate2_tpu_torch.kernels.quant_matmul import (
        matmul_w8a8, matmul_w8a8_plain)

    g = torch.Generator(device="cuda").manual_seed(0)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    library_ok = True
    max_err = 0.0
    for (M, K, N), n in sorted(shapes.items()):
        q = torch.randint(-128, 128, (M, K), generator=g, device="cuda",
                          dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, device="cuda",
                           dtype=torch.int8)
        a_s = torch.rand(M, generator=g, device="cuda") * 5 + 0.5
        w_s = torch.rand(N, generator=g, device="cuda") * 5 + 0.5
        plan = qm.w8a8_plan(M, N, K)
        other = w8a8_other_plan(qm, M, K, N)
        out = matmul_w8a8(q, wq, a_s, w_s)
        ref = matmul_w8a8_plain(q, wq, a_s, w_s)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        max_err = max(max_err, err)
        checks(torch.equal(out, ref), f"w8a8 bit-equal to plain at {(M, K, N)} ({plan.path})")
        if other is not None:
            checks(torch.equal(qm._w8a8_launch(q, wq, a_s, w_s, other), ref),
                   f"w8a8 {other.path} path bit-equal to plain at {(M, K, N)}")
        iters = 50 if M * N * K < 2**32 else 10
        ms = cuda_time_ms(lambda: matmul_w8a8(q, wq, a_s, w_s), iters)
        other_ms = (None if other is None else cuda_time_ms(
            lambda: qm._w8a8_launch(q, wq, a_s, w_s, other), iters))
        plain_ms = cuda_time_ms(lambda: matmul_w8a8_plain(q, wq, a_s, w_s), iters)
        try:
            wt = wq.t()
            # torch._int_mm wants more than 16 rows: the decode shapes are
            # padded to 32 rows of zeros for it (timed only).
            ql = q if M >= 32 else torch.cat([q, q.new_zeros((32 - M, K))])
            lib_ms = cuda_time_ms(
                lambda: torch._int_mm(ql, wt)[:M].float() / (a_s[:, None] * w_s[None, :]),
                iters)
        except RuntimeError as e:  # torch._int_mm refuses some shapes
            lib_ms, library_ok = None, False
            emit({"library_refused": [M, K, N], "error": str(e)[:200]})
        bytes_ms = (M * K + N * K + 4 * M * N + 4 * M + 4 * N) / PEAK_BYTES * 1e3
        ops_ms = 2 * M * N * K / PEAK_INT8_OPS * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        emit({"phase": "kernel_w8a8", "M": M, "K": K, "N": N,
              "path": plan.path, "splits": plan.splits, "tile": list(plan.tile),
              "launches": n, "max_abs_err": err, "kernel_ms": ms,
              "tops": 2 * M * N * K / ms / 1e9, "share_of_bound": bound_ms / ms,
              "other_path": None if other is None else other.path,
              "other_path_splits": None if other is None else other.splits,
              "other_path_ms": other_ms,
              "plain_ms": plain_ms, "library_ms": lib_ms,
              "bound_ms": bound_ms,
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **extra})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["library_ms"] += n * (lib_ms or 0.0)
        tot["bytes_ms"] += n * bytes_ms
        tot["ops_ms"] += n * ops_ms
    tot["library_ms"] = tot["library_ms"] if library_ok else None
    tot["max_abs_err"] = max_err
    return tot


def _random_array(shape, dtype, g):
    """Random values of ``dtype`` made in that type (a slot cache of
    gigabytes must not pass through float32)."""
    import torch

    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    return torch.randint(-100, 100, shape, generator=g, device="cuda", dtype=dtype)


def bench_gather(shapes, checks, **extra):
    """Kernel vs plain (= the library's index_select loop) at each call
    shape, weighted by its launches on the main path; returns the sums."""
    import torch
    from ctranslate2_tpu_torch.kernels.gather_rows import (
        gather_rows_fused, gather_rows_plain)

    g = torch.Generator(device="cuda").manual_seed(1)
    tot = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0)
    max_err = 0.0
    for (specs, n_rows), n in sorted(shapes.items()):
        arrays = [_random_array(shape, getattr(torch, dt.split(".")[1]), g)
                  for shape, dt in specs]
        rows = torch.randint(0, specs[0][0][0], (n_rows,), generator=g,
                             device="cuda", dtype=torch.int32)
        out = gather_rows_fused(arrays, rows)
        ref = gather_rows_plain(arrays, rows)
        torch.cuda.synchronize()
        err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
        max_err = max(max_err, err)
        checks(all(torch.equal(o, r) for o, r in zip(out, ref)),
               f"gather equal to plain at {len(specs)} arrays x {n_rows} rows")
        ms = cuda_time_ms(lambda: gather_rows_fused(arrays, rows), 100)
        plain_ms = cuda_time_ms(lambda: gather_rows_plain(arrays, rows), 100)
        nbytes = sum(a.numel() * a.element_size() for a in arrays) \
            * n_rows // specs[0][0][0]
        bytes_ms = 2 * nbytes / PEAK_BYTES * 1e3
        emit({"phase": "kernel_gather", "arrays": [list(s) for s, _ in specs][:1],
              "num_arrays": len(specs), "dtype": specs[0][1], "rows": n_rows,
              "launches": n, "max_abs_err": err, "kernel_ms": ms,
              "plain_ms": plain_ms, "library_ms": plain_ms,
              "bytes_moved": 2 * nbytes, "bound_ms": bytes_ms, "bound_by": "bytes",
              **extra})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["bytes_ms"] += n * bytes_ms
    tot["max_abs_err"] = max_err
    return tot


def _flash_inputs(g, B, Hq, Hkv, Tq, Tk, D, dtype):
    import torch

    def t(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    return t(B, Hq, Tq, D), t(B, Hkv, Tk, D), t(B, Hkv, Tk, D)


def _attention_mask(B, Tq, Tk, causal, lengths, window):
    """[B, 1, Tq, Tk] bool: the (query, key) pairs ``flash_attention_plain``
    attends to."""
    import torch

    q_pos = torch.arange(Tq, device="cuda")[:, None]
    k_pos = torch.arange(Tk, device="cuda")[None, :]
    mask = torch.ones((B, 1, Tq, Tk), dtype=torch.bool, device="cuda")
    if causal:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    if lengths is not None:
        mask &= k_pos < lengths[:, None, None, None]
    return mask


def _flash_extras(g, Hq, Tq, Tk, alibi, t5):
    """The flash kwargs of a logged ALiBi convention and T5 (buckets, max
    distance, bidirectional), and their additive bias [1, Hq, Tq, Tk]
    float32 for the library call (None without either): the published
    slopes of Hq heads, a drawn bucket table."""
    import torch
    from ctranslate2_tpu_torch.kernels.flash_attention import relative_position_bucket
    from ctranslate2_tpu_torch.ops.positions import alibi_slopes

    kw, bias = {}, None
    q_pos = torch.arange(Tq, device="cuda")[:, None]
    k_pos = torch.arange(Tk, device="cuda")[None, :]
    if alibi is not None:
        slopes = torch.from_numpy(alibi_slopes(Hq)).cuda()
        kw.update(alibi_slopes=slopes, alibi_positive=alibi)
        offs = 0 if alibi else Tq - 1
        bias = slopes[:, None, None] * (k_pos - offs).float()[None]
    if t5 is not None:
        nb, maxd, bidirectional = t5
        table = torch.randn((nb, Hq), generator=g, device="cuda") * 0.5
        kw.update(rel_bias_table=table, rel_max_distance=maxd,
                  rel_bidirectional=bidirectional)
        bucket = relative_position_bucket(k_pos - q_pos, nb, maxd, bidirectional)
        t5_bias = table.t()[:, bucket]
        bias = t5_bias if bias is None else bias + t5_bias
    return kw, None if bias is None else bias[None]


def bench_flash(shapes, checks, **extra):
    """The flash kernel at every main-path shape against its plain version
    (computed in float32 from the same inputs) and, timed only,
    ``F.scaled_dot_product_attention``: with ``is_causal`` where the
    attention is at most causal, else with the mask built from the lengths,
    causality and window, and with ALiBi or the T5 bias as a float mask
    (the bias, and -inf where masked); the faster of its GQA call and a call
    on K and V repeated to every query head beforehand. The bound counts
    the (query, key) pairs that this run's lengths leave, and K and V only
    up to each row's length; ``extra`` goes into each line."""
    import torch
    import torch.nn.functional as F
    from ctranslate2_tpu_torch.kernels import flash_attention as fa
    from ctranslate2_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device="cuda").manual_seed(2)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
               max_abs_err=0.0)
    for key, n in sorted(shapes.items(), key=lambda kv: str(kv[0])):
        (B, Hq, Tq, D), Hkv, Tk, dt, causal, has_lengths, window, *more = key
        alibi, t5 = (more + [None, None])[:2]
        dtype = getattr(torch, dt)
        q, k, v = _flash_inputs(g, B, Hq, Hkv, Tq, Tk, D, dtype)
        lengths = (torch.randint(Tk // 2, Tk + 1, (B,), generator=g, device="cuda",
                                 dtype=torch.int32) if has_lengths else None)
        extras, bias = _flash_extras(g, Hq, Tq, Tk, alibi, t5)
        kw = dict(scale=D ** -0.5, causal=causal, lengths=lengths, window=window, **extras)
        out = flash_attention(q, k, v, **kw)
        ref = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref).abs().max().item()
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        checks(torch.allclose(out.float(), ref, **FLASH_TOL[dt]),
               f"flash within {FLASH_TOL[dt]} of plain at {key} (max abs err {err})")
        del ref
        ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw), 5)
        launch_order_ms = None
        if causal:  # the causal query tiles in launch order instead
            fa.HEAVIEST_FIRST = False
            try:
                launch_order_ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw), 5)
            finally:
                fa.HEAVIEST_FIRST = True
        plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, **kw), 3)
        mask = _attention_mask(B, Tq, Tk, causal, lengths, window)
        pairs = int(mask.sum().item())
        library_calls = {}
        if bias is not None:
            attn_mask = bias.masked_fill(~mask, float("-inf")).to(dtype)
            name = "float_mask"
        elif lengths is None and not window:
            attn_mask, name = None, "is_causal" if causal else "unmasked"
        else:
            attn_mask, name = mask, "mask"
        lib_causal = attn_mask is None and causal
        library_calls[name] = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=lib_causal, scale=D ** -0.5,
                enable_gqa=Hq != Hkv), 5)
        if Hq != Hkv:
            k_rep = k.repeat_interleave(Hq // Hkv, dim=1)
            v_rep = v.repeat_interleave(Hq // Hkv, dim=1)
            library_calls[name + "_heads_repeated"] = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k_rep, v_rep, attn_mask=attn_mask, is_causal=lib_causal,
                    scale=D ** -0.5), 5)
            del k_rep, v_rep
        del mask, attn_mask, bias
        lib_ms = min(library_calls.values())
        ops = 4.0 * Hq * D * pairs
        peak = PEAK_F32_FLOPS if dt == "float32" else PEAK_HALF_FLOPS
        ops_ms = ops / peak * 1e3
        kv_rows = (B * Tk if lengths is None
                   else int(lengths.clamp(max=Tk).sum().item()))
        bytes_ms = ((2 * q.numel() + 2 * Hkv * D * kv_rows) * q.element_size()
                    / PEAK_BYTES * 1e3)
        emit({"phase": "kernel_flash", "q": [B, Hq, Tq, D], "kv": [B, Hkv, Tk, D],
              "dtype": dt, "causal": causal, "lengths": has_lengths, "window": window,
              "alibi_positive": alibi, "t5_buckets_max_distance_bidirectional": t5,
              "launches": n, "max_abs_err": err, "tolerance": FLASH_TOL[dt],
              "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
              "library": "F.scaled_dot_product_attention",
              "library_calls_ms": library_calls, "pairs": pairs,
              "lengths_drawn": None if lengths is None else lengths.tolist(),
              "flops": ops, "tflops": ops / ms / 1e9,
              "share_of_bound": max(ops_ms, bytes_ms) / ms,
              "heaviest_first": causal, "launch_order_ms": launch_order_ms,
              "bound_ms": max(ops_ms, bytes_ms),
              "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", **extra})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["library_ms"] += n * lib_ms
        tot["bytes_ms"] += n * bytes_ms
        tot["ops_ms"] += n * ops_ms
    return tot


def _decode_inputs(g, B, Hq, Hkv, C, D, dtype, fresh, lengths):
    import torch
    from ctranslate2_tpu_torch.kernels.decode_attention import quantize_kv

    def t(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    k8, ks = quantize_kv(t(B, Hkv, C, D))
    v8, vs = quantize_kv(t(B, Hkv, C, D))
    kw = {}
    if fresh:
        kw["k_new8"], kw["kn_scale"] = quantize_kv(t(B, Hkv, 1, D))
        kw["v_new8"], kw["vn_scale"] = quantize_kv(t(B, Hkv, 1, D))
    lengths = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return (t(B, Hq, 1, D).to(dtype), k8, ks, v8, vs, lengths), kw


def bench_decode(shapes, first_length, steps, checks, **extra):
    """The int8-KV decode kernel at every main-path shape, with cache
    lengths spread over those of the run's steps. No single PyTorch call
    computes this function, so there is no library time. ``extra`` goes
    into each line."""
    import torch
    from ctranslate2_tpu_torch.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_plain, decode_plan)

    g = torch.Generator(device="cuda").manual_seed(3)
    tot = dict(ms=0.0, plain_ms=0.0, bytes_ms=0.0, ops_ms=0.0, max_abs_err=0.0)
    for key, n in sorted(shapes.items()):
        (B, Hq, _, D), Hkv, C, dt, fresh, window = key
        # Lengths from the first step's to the last step's: their mean is
        # the mean over the run.
        lengths = [first_length + round(i * (steps - 1) / max(B - 1, 1))
                   for i in range(B)]
        args, kw = _decode_inputs(g, B, Hq, Hkv, C, D, getattr(torch, dt),
                                  fresh, lengths)
        kw.update(scale=D ** -0.5, window=window)
        out = decode_attention_int8(*args, **kw)
        ref = decode_attention_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        checks(torch.allclose(out, ref, **DECODE_TOL),
               f"decode within {DECODE_TOL} of plain at {key} (max abs err {err})")
        ms = cuda_time_ms(lambda: decode_attention_int8(*args, **kw), 50)
        # The launch's fixed cost: the same call with every row at length 1.
        ones = (*args[:5], torch.ones_like(args[5]))
        fixed_ms = cuda_time_ms(lambda: decode_attention_int8(*ones, **kw), 50)
        plain_ms = cuda_time_ms(lambda: decode_attention_int8_plain(*args, **kw), 20)
        # The wrapper's rule: with a fresh key the window shows window - 1
        # cache keys, and none when it is 1.
        shown = window - 1 if fresh and window else window
        keys = sum(0 if fresh and window == 1 else (min(lng, shown) if shown else lng)
                   for lng in lengths)
        nbytes = keys * Hkv * (2 * D + 8) + (2 * Hkv * (D + 4) * B if fresh else 0) \
            + B * Hq * D * (args[0].element_size() + 4)
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        # float16 q with D a multiple of 16 runs on the tensor cores
        # (decode_mma_kernel); the rest on f32 FMAs.
        mma = dt == "float16" and D % 16 == 0
        ops_ms = 4.0 * keys * Hq * D / (PEAK_HALF_FLOPS if mma else PEAK_F32_FLOPS) * 1e3
        plan = decode_plan(B, Hkv, Hq // Hkv, C, D,
                           torch.cuda.get_device_properties(0).multi_processor_count)
        emit({"phase": "kernel_decode", "q": [B, Hq, 1, D], "cache": [B, Hkv, C, D],
              "dtype": dt, "fresh": fresh, "window": window, "lengths": lengths,
              "plan": plan._asdict(),
              "launches": n, "max_abs_err": err, "tolerance": DECODE_TOL,
              "kernel_ms": ms, "fixed_ms_at_length_1": fixed_ms,
              "plain_ms": plain_ms, "library_ms": None,
              "bytes_moved": nbytes, "gbytes_per_s": nbytes / ms / 1e6,
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **extra})
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["bytes_ms"] += n * bytes_ms
        tot["ops_ms"] += n * ops_ms
    return tot


def bench_gemma2_attention(checks):
    """Timed rows, not summed into the main paths' totals, at Gemma-2-9B's
    attention widths (``GEMMA2_ATTENTION``: 16 query and 8 KV heads of 256)
    and the Generator's batch and lengths: the prefill's flash call (float16,
    causal) and the int8-KV decode call."""
    B, Hq, Hkv, D = (GEMMA2_ATTENTION[k] for k in ("batch", "heads", "heads_kv", "head_dim"))
    T = GEN_PROMPT - 1
    extra = dict(config="gemma-2-9b attention widths", summed=False)
    bench_flash({((B, Hq, T, D), Hkv, T, "float16", True, False, 0): 0}, checks, **extra)
    free_card()
    bench_decode({((B, Hq, 1, D), Hkv, T + GEN_NEW + 64, "float16", True, 0): 0},
                 T, GEN_NEW, checks, **extra)


def norm_close(out, ref, beta):
    """float32: ``NORM_F32_TOL``. Half types: one ulp of the output type,
    taken at the scale of the terms where beta cancels the scaled value."""
    import torch

    if out.dtype == torch.float32:
        return torch.allclose(out, ref, **NORM_F32_TOL)
    ulp = 2.0 ** (-10 if out.dtype == torch.float16 else -7)
    scale = ref.float().abs().clamp_min(2.0 ** -14)
    if beta is not None:
        scale = torch.maximum(scale, beta.abs().expand_as(scale))
    return bool(((out.float() - ref.float()).abs() <= ulp * scale).all())


NORM_FORMS = {  # (residual, quantize, keep_sum, keep_y) -> the form's name
    (False, False, True, True): "norm",
    (True, False, True, True): "residual",
    (True, False, False, True): "residual_no_sum",
    (False, True, True, False): "int8",
    (True, True, True, False): "residual_int8",
    (True, True, False, False): "residual_int8_no_sum"}


def fused_norm_checks(x, r, gamma, beta, residual, quantize, checks, label):
    """A fused form against its plain version on the same inputs: the sum
    bit-equal to the plain add; y within one ulp (``norm_close``); q and
    scale bit-equal to ``quantize_per_row`` of the kernel's own y, and
    within one int8 step of the plain sequence on at most
    ``FED_STEP_SHARE`` of the entries. Returns the largest y difference."""
    import torch
    from ctranslate2_tpu_torch.kernels.norms import fused_norm, fused_norm_plain
    from ctranslate2_tpu_torch.ops.linear import quantize_per_row

    kw = dict(eps=1e-5, residual=r if residual else None, quantize=quantize)
    out = fused_norm(x, gamma, beta, **kw)
    ref = fused_norm_plain(x, gamma, beta, **kw)
    if not (residual or quantize):
        out, ref = (out, None, None, None), (ref, None, None, None)
    else:
        out, ref = (out.y, out.sum, out.q, out.scale), (ref.y, ref.sum, ref.q, ref.scale)
    torch.cuda.synchronize()
    err = (out[0].float() - ref[0].float()).abs().max().item()
    checks(norm_close(out[0], ref[0], beta),
           f"norm {label} y within one ulp of plain (max abs err {err})")
    if residual:
        checks(torch.equal(out[1], ref[1]), f"norm {label}: the sum bit-equal to the plain add")
    if quantize:
        q, scale = quantize_per_row(out[0])
        checks(torch.equal(out[2], q) and torch.equal(out[3], scale),
               f"norm {label}: q and scale bit-equal to quantize_per_row of its y")
        step = (out[2].int() - ref[2].int()).abs()
        share = (step > 0).float().mean().item()
        checks(int(step.max()) <= 1 and share <= FED_STEP_SHARE,
               f"norm {label}: q within one int8 step of the plain sequence on at "
               f"most {FED_STEP_SHARE} of the entries (max step {int(step.max())}, "
               f"share {share})")
    return err


def bench_norm(shapes, checks, unsummed=None, **extra):
    """The norm kernel in each form at every main-path shape (``shapes``:
    the Translator and int8 Generator paths', summed; ``unsummed``: the AWQ
    path's, timed with weight 0) against its plain version (the eager
    sequence: add, norm, ``quantize_per_row``), with the time of the
    launches the form replaces (the eager add, the norm kernel alone and
    ``quantize_per_row``, in one CUDA graph) and, timed only, ``F.rms_norm``
    / ``F.layer_norm`` of the norm alone (no PyTorch call fuses the add or
    the quantization)."""
    import torch
    import torch.nn.functional as F
    from ctranslate2_tpu_torch.kernels.norms import fused_norm, fused_norm_plain
    from ctranslate2_tpu_torch.ops.linear import quantize_per_row

    g = torch.Generator(device="cuda").manual_seed(4)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, max_abs_err=0.0,
               replaced_ms=0.0, forms={})
    rows_all = {key: (n, True) for key, n in shapes.items()}
    for key, n in (unsummed or {}).items():
        rows_all.setdefault(key, (0, False))
    for key, (n, summed) in sorted(rows_all.items()):
        rows, D, dt, has_beta, residual, quantize, keep_sum, keep_y = key
        form = (residual, quantize, keep_sum, keep_y)
        name = NORM_FORMS[form]
        dtype = getattr(torch, dt)
        x = (torch.randn((rows, D), generator=g, device="cuda") * 2 + 0.5).to(dtype)
        r = torch.randn((rows, D), generator=g, device="cuda").to(dtype) if residual else None
        gamma = torch.randn(D, generator=g, device="cuda")
        beta = torch.randn(D, generator=g, device="cuda") if has_beta else None
        err = fused_norm_checks(x, r, gamma, beta, residual, quantize, checks,
                                f"{name} at {key}")
        tot["max_abs_err"] = max(tot["max_abs_err"], err)
        kw = dict(eps=1e-5)
        if residual or quantize:
            kw.update(residual=r, quantize=quantize, keep_sum=keep_sum, keep_y=keep_y)
        iters = 100 if rows * D < 2**22 else 20
        ms = cuda_time_ms(lambda: fused_norm(x, gamma, beta, **kw), iters)
        plain_ms = cuda_time_ms(lambda: fused_norm_plain(x, gamma, beta, **kw), iters)

        def replaced():
            y = fused_norm(x + r if residual else x, gamma, beta, eps=1e-5)
            return quantize_per_row(y) if quantize else y

        replaced_ms = cuda_time_ms(replaced, iters)
        small = rows * D < 2**22  # the card outpaces the host: a decode shape
        host = ({"host_us": host_us(lambda: fused_norm(x, gamma, beta, **kw)),
                 "replaced_host_us": host_us(replaced)} if small else {})
        gx = gamma.to(dtype)
        if has_beta:
            bx = beta.to(dtype)
            lib_ms = cuda_time_ms(lambda: F.layer_norm(x, (D,), gx, bx, 1e-5), iters)
        else:
            lib_ms = cuda_time_ms(lambda: F.rms_norm(x, (D,), gx, 1e-5), iters)
        size = x.element_size()
        nbytes = (rows * D * size * (1 + residual + (residual and keep_sum) + keep_y)
                  + (rows * D + 4 * rows if quantize else 0)
                  + 4 * D * (2 if has_beta else 1))
        bytes_ms = nbytes / PEAK_BYTES * 1e3
        emit({"phase": "kernel_norm", "form": name, "rows": rows, "D": D, "dtype": dt,
              "layer_norm": has_beta, "residual": residual, "quantize": quantize,
              "writes_sum": residual and keep_sum, "writes_y": keep_y,
              "launches": n, "summed": summed, "max_abs_err": err,
              "kernel_ms": ms, "plain_ms": plain_ms, "replaced_ms": replaced_ms,
              "replaced": "eager add + norm kernel + quantize_per_row, one CUDA graph",
              "library_ms": lib_ms, "library": ("F.layer_norm" if has_beta else "F.rms_norm")
              + " of the norm alone",
              "bytes_moved": nbytes, "bound_ms": bytes_ms, "bound_by": "bytes",
              "share_of_bound": bytes_ms / ms, **host, **extra})
        f = tot["forms"].setdefault(name, dict(launches=0, ms=0.0, replaced_ms=0.0,
                                                bound_ms=0.0))
        f["launches"] += n
        f["ms"] += n * ms
        f["replaced_ms"] += n * replaced_ms
        f["bound_ms"] += n * bytes_ms
        tot["ms"] += n * ms
        tot["plain_ms"] += n * plain_ms
        tot["replaced_ms"] += n * replaced_ms
        tot["library_ms"] += n * lib_ms
        tot["bytes_ms"] += n * bytes_ms
        del x, r
    return tot


def feature_checks(checks):
    """Small shapes on the card for every feature the main paths do not
    use: each kernel against its plain version."""
    import torch
    from ctranslate2_tpu_torch.kernels.decode_attention import (
        decode_attention_int8, decode_attention_int8_plain)
    from ctranslate2_tpu_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)
    from ctranslate2_tpu_torch.kernels.norms import fused_norm, fused_norm_plain

    g = torch.Generator(device="cuda").manual_seed(5)
    B, T = 2, 150

    def i32(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    def slopes(h):
        return torch.tensor([0.5 ** (i + 1) for i in range(h)], device="cuda")

    def table(h):
        return torch.randn((12, h), generator=g, device="cuda")

    segments = torch.sort(torch.randint(0, 3, (B, T), generator=g, device="cuda",
                                        dtype=torch.int32), dim=1).values
    flash_cases = [
        ("non_causal_lengths", "float16", 128, 4, 2, T, T, dict(lengths=i32([37, T]))),
        ("window", "float16", 64, 4, 4, T, T, dict(causal=True, window=17)),
        ("segment_ids", "float16", 128, 4, 2, T, T, dict(causal=True, segment_ids=segments)),
        ("alibi_negative", "bfloat16", 64, 4, 2, T, T,
         dict(causal=True, alibi_slopes=slopes(4), alibi_positive=False)),
        ("alibi_positive", "float16", 64, 4, 4, T, T,
         dict(causal=True, alibi_slopes=slopes(4), alibi_positive=True)),
        ("t5_causal", "float16", 64, 4, 4, T, T,
         dict(causal=True, rel_bias_table=table(4), rel_max_distance=50,
              rel_bidirectional=False)),
        ("t5_bidirectional", "float32", 64, 4, 2, T, T,
         dict(rel_bias_table=table(4), rel_max_distance=50, rel_bidirectional=True)),
        ("q_offset", "float16", 128, 4, 2, 60, T, dict(causal=True, q_offset=5)),
        ("bf16_mqa", "bfloat16", 128, 4, 1, T, T, dict(causal=True)),
        ("f32_head_dim_128", "float32", 128, 2, 2, T, T, dict(causal=True, lengths=i32([T, 9]))),
        ("masked_rows", "float16", 64, 2, 2, T, T, dict(lengths=i32([0, T]))),
        # Head dims off 64/128 run zero-padded to the next instance.
        ("head_dim_80", "float16", 80, 4, 2, T, T, dict(causal=True, lengths=i32([T, 101]))),
        ("head_dim_96", "bfloat16", 96, 4, 2, T, T, dict(lengths=i32([37, T]))),
        ("head_dim_32_f32", "float32", 32, 4, 1, T, T, dict(causal=True)),
        # D = 256 (one consumer warpgroup; float32 16-key tiles), and 160 /
        # 192 zero-padded to it.
        ("head_dim_256_gqa", "float16", 256, 4, 2, T, T, dict(causal=True)),
        ("head_dim_256_lengths", "bfloat16", 256, 4, 2, T, T, dict(lengths=i32([37, T]))),
        ("head_dim_256_window", "float16", 256, 4, 4, T, T, dict(causal=True, window=17)),
        ("head_dim_256_segments", "float16", 256, 4, 2, T, T,
         dict(causal=True, segment_ids=segments)),
        ("head_dim_256_f32", "float32", 256, 4, 2, T, T,
         dict(causal=True, lengths=i32([T, 9]))),
        ("head_dim_192", "bfloat16", 192, 4, 2, T, T, dict(causal=True, lengths=i32([T, 101]))),
        ("head_dim_160_f32", "float32", 160, 4, 1, T, T, dict(alibi_slopes=slopes(4))),
    ]
    worst = {}
    for name, dt, D, Hq, Hkv, Tq, Tk, kw in flash_cases:
        q, k, v = _flash_inputs(g, B, Hq, Hkv, Tq, Tk, D, getattr(torch, dt))
        out = flash_attention(q, k, v, scale=D ** -0.5, **kw)
        ref = flash_attention_plain(q.float(), k.float(), v.float(), scale=D ** -0.5, **kw)
        torch.cuda.synchronize()
        worst[f"flash_{name}"] = err = (out.float() - ref).abs().max().item()
        checks(torch.allclose(out.float(), ref, **FLASH_TOL[dt]),
               f"flash feature {name} ({dt}, D={D}) within {FLASH_TOL[dt]} (got {err})")

    decode_cases = [
        ("window_fresh", "float16", 8, 2, 300, 64, True, 9, [300, 17, 0]),
        ("window_one", "float32", 8, 2, 300, 64, True, 1, [300, 17, 0]),
        ("no_fresh", "float16", 32, 8, 2176, 128, False, 0, [2048, 2111, 1]),
        ("no_fresh_window", "bfloat16", 6, 1, 130, 32, False, 7, [130, 64, 5]),
        ("head_dim_256", "float32", 4, 2, 70, 256, True, 0, [70, 33, 2]),
        ("head_dim_256_gemma2", "float16", 16, 8, 2176, 256, True, 0, [2048, 0, 1, 2111]),
        # Head dims off a multiple of 16: rows start anywhere in a chunk.
        ("head_dim_72", "float16", 8, 2, 300, 72, True, 0, [300, 17, 0]),
        ("head_dim_72_window", "bfloat16", 8, 2, 300, 72, True, 9, [300, 17, 1]),
        ("head_dim_72_window_one", "float32", 8, 2, 300, 72, True, 1, [300, 17, 0]),
        ("head_dim_72_no_fresh", "float16", 12, 4, 130, 72, False, 0, [0, 130, 65]),
        ("head_dim_200", "float32", 5, 1, 70, 200, True, 7, [0, 70, 9]),
    ]
    for name, dt, Hq, Hkv, C, D, fresh, window, lengths in decode_cases:
        args, kw = _decode_inputs(g, len(lengths), Hq, Hkv, C, D, getattr(torch, dt),
                                  fresh, lengths)
        kw.update(scale=D ** -0.5, window=window)
        out = decode_attention_int8(*args, **kw)
        ref = decode_attention_int8_plain(*args, **kw)
        torch.cuda.synchronize()
        worst[f"decode_{name}"] = err = (out - ref).abs().max().item()
        checks(torch.allclose(out, ref, **DECODE_TOL),
               f"decode feature {name} within {DECODE_TOL} (got {err})")

    for name, dt, shape, has_beta in [
            ("layer_norm_beta", "float16", (3, 5, 512), True),
            ("layer_norm_f32", "float32", (7, 24), True),
            ("rms_bf16_long_row", "bfloat16", (2, 17000), False),
            # Widths off a multiple of 8 take the scalar-load instance.
            ("layer_norm_odd_width", "float16", (5, 4097), True),
            ("rms_width_100", "bfloat16", (9, 100), False),
            ("layer_norm_width_12_f32", "float32", (3, 12), True)]:
        x = (torch.randn(shape, generator=g, device="cuda") * 2 + 0.5).to(getattr(torch, dt))
        gamma = torch.randn(shape[-1], generator=g, device="cuda")
        beta = torch.randn(shape[-1], generator=g, device="cuda") if has_beta else None
        out = fused_norm(x, gamma, beta, eps=1e-5)
        ref = fused_norm_plain(x, gamma, beta, eps=1e-5)
        torch.cuda.synchronize()
        worst[f"norm_{name}"] = (out.float() - ref.float()).abs().max().item()
        checks(norm_close(out, ref, beta), f"norm feature {name} within one ulp of plain")
        # The fused forms at the same widths.
        r = torch.randn(shape, generator=g, device="cuda").to(x.dtype)
        for residual, quantize in ((True, False), (False, True), (True, True)):
            form = NORM_FORMS[residual, quantize, True, not quantize]
            worst[f"norm_{name}_{form}"] = fused_norm_checks(
                x, r, gamma, beta, residual, quantize, checks, f"feature {name} {form}")
    emit({"phase": "kernel_features", "max_abs_err": worst})


# ---------------------------------------------------------------------------
# Generator: the Llama-3-8B geometry.
# ---------------------------------------------------------------------------

def _llama_file(layers, cfg=LLAMA, seed=0, **config):
    """A Llama geometry's (``cfg``, Llama-3-8B's by default) attributes and
    norms in a new in-memory ModelFile (``config`` added to its config),
    and its weight matrices as (scope, out_dim, in_dim, seed) jobs,
    embeddings and projection first, their seeds offset by ``seed``."""
    import numpy as np
    from ctranslate2_tpu_torch.formats.model_file import ModelFile, make_variable

    d, heads, heads_kv = cfg["d_model"], cfg["heads"], cfg["heads_kv"]
    head_dim = d // heads
    mf = ModelFile(spec_name="TransformerDecoderSpec", spec_revision=8,
                   binary_version=6)
    mf.config = {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
                 "layer_norm_epsilon": 1e-5, **config}

    def add(name, value, dtype=None):
        mf.variables[name] = make_variable(name, value, dtype)

    sc = "decoder"
    add(f"{sc}/num_heads", heads, "int16")
    add(f"{sc}/pre_norm", 1, "int8")
    add(f"{sc}/activation", 2, "int8")  # swish
    add(f"{sc}/scale_embeddings", 0, "int8")
    add(f"{sc}/layer_norm/gamma", np.ones(d, np.float32))
    jobs = [(f"{sc}/embeddings", cfg["vocab"], d, seed),
            (f"{sc}/projection", cfg["vocab"], d, seed + 1)]
    for i in range(layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        jobs.append((f"{asc}/linear_0", (heads + 2 * heads_kv) * head_dim, d, seed + 10 + i))
        jobs.append((f"{asc}/linear_1", d, heads * head_dim, seed + 1000 + i))
        add(f"{asc}/layer_norm/gamma", np.ones(d, np.float32))
        add(f"{asc}/num_heads_kv", heads_kv, "int32")
        add(f"{asc}/rotary_dim", 0, "int32")
        add(f"{asc}/rotary_interleave", 0, "int8")
        add(f"{asc}/rotary_base", cfg["rotary_base"], "float32")
        jobs.append((f"{ls}/ffn/linear_0", cfg["d_ff"], d, seed + 2000 + i))
        jobs.append((f"{ls}/ffn/linear_0_noact", cfg["d_ff"], d, seed + 3000 + i))
        jobs.append((f"{ls}/ffn/linear_1", d, cfg["d_ff"], seed + 4000 + i))
        add(f"{ls}/ffn/layer_norm/gamma", np.ones(d, np.float32))
    return mf, jobs


def _draw_into(mf, jobs, draw):
    """Adds the variables ``draw(job)`` returns for every job, several jobs at
    a time on a thread pool (numpy releases the interpreter lock while it
    draws). ``draw`` returns (scope, {suffix: array})."""
    from concurrent.futures import ThreadPoolExecutor

    from ctranslate2_tpu_torch.formats.model_file import make_variable

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        for scope, arrays in pool.map(draw, jobs):
            for suffix, value in arrays.items():
                name = f"{scope}/{suffix}"
                mf.variables[name] = make_variable(name, value)
    return mf


def build_llama_modelfile(layers, cfg=LLAMA, seed=0, tied=False):
    """A Llama geometry (Llama-3-8B's by default) fabricated directly as int8
    payloads and scales, in memory (no float intermediates): every linear's
    payload is drawn from its own seed. With ``tied`` the projection is the
    embeddings' arrays, as the converter writes tied embeddings."""
    from ctranslate2_tpu_torch.formats.model_file import make_variable

    mf, jobs = _llama_file(layers, cfg, seed)
    if tied:
        jobs = [j for j in jobs if not j[0].endswith("/projection")]
    mf = _draw_into(mf, jobs, _int8_payload)
    if tied:
        for suffix in ("weight", "weight_scale"):
            name = f"decoder/projection/{suffix}"
            mf.variables[name] = make_variable(
                name, mf.variables[f"decoder/embeddings/{suffix}"].array)
    return mf


def _int8_payload(job):
    """An int8 weight of (scope, rows, cols, seed): payload drawn from the
    seed, every row's scale 127 / 0.05 (weights within +-0.05)."""
    import numpy as np

    scope, rows, cols, seed = job
    q = np.random.default_rng(seed).integers(-127, 128, (rows, cols), dtype=np.int8)
    return scope, {"weight": q, "weight_scale": np.full((rows,), 127.0 / 0.05, np.float32)}


def build_awq_llama_modelfile(layers):
    """The same geometry as AutoAWQ's GEMM checkpoints store it (group 128,
    zero points; ``quantization_type`` 1), fabricated in memory: each layer
    linear's ``weight`` int32 [in, out/8] of random nibbles, ``weight_scale``
    f32 [in/128, out] in [0.005, 0.0075] and ``weight_zero`` int32
    [in/128, out/8] of zero points 7 and 8, so that (q - z) * s is centred
    and about as wide as the int8 model's weights; float16 embeddings and
    projection, as the reference's converter leaves them."""
    import numpy as np
    from ctranslate2_tpu_torch.ops.awq import AWQ_GEMM, pack_awq_gemm

    G = AWQ_GROUP
    mf, jobs = _llama_file(layers, quantization_type=AWQ_GEMM,
                           quantization_bits=4, quantization_group_size=G)

    def draw(job):
        scope, out_dim, in_dim, seed = job
        rng = np.random.default_rng(seed)
        if not re.search(r"/layer_\d+/", scope):  # embeddings, projection
            w = np.empty((out_dim, in_dim), np.float16)
            for r in range(0, out_dim, 16384):
                rows = min(16384, out_dim - r)
                w[r:r + rows] = rng.random((rows, in_dim), dtype=np.float32) * 0.1 - 0.05
            return scope, {"weight": w}
        return scope, {
            "weight": rng.integers(0, 2 ** 32, (in_dim, out_dim // 8),
                                   dtype=np.uint32).view(np.int32),
            "weight_scale": rng.random((in_dim // G, out_dim), dtype=np.float32)
                            * 0.0025 + 0.005,
            "weight_zero": pack_awq_gemm(
                rng.integers(7, 9, (in_dim // G, out_dim), dtype=np.uint8))}

    return _draw_into(mf, jobs, draw)


def llama_subset(mf, layers):
    """The first ``layers`` layers of a fabricated model, sharing its arrays."""
    from ctranslate2_tpu_torch.formats.model_file import ModelFile

    sub = ModelFile(spec_name=mf.spec_name, spec_revision=mf.spec_revision,
                    binary_version=mf.binary_version)
    sub.config = dict(mf.config)
    for name, var in mf.variables.items():
        layer = re.match(r"decoder/layer_(\d+)/", name)
        if layer and int(layer.group(1)) >= layers:
            continue
        sub.variables[name] = var
    return sub


def make_generator(tt, mf, vocab, **kwargs):
    """A Generator on an in-memory model, which carries no vocabulary file:
    the vocabulary is handed to the loaded model."""
    gen = tt.Generator(mf, **kwargs)
    gen.model.target_vocabulary = vocab
    return gen


def make_prompts(vocab, length, seed):
    import numpy as np

    r = np.random.default_rng(2000 + seed)
    return [[vocab.to_token(int(t)) for t in r.integers(10, LLAMA["vocab"] - 10, length)]
            for _ in range(GEN_BATCH)]


@contextlib.contextmanager
def environ(**values):
    """Sets environment variables for one block."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def generate_run(gen, prompts, new_tokens=GEN_NEW, **kwargs):
    """One timed generate_batch call (``kwargs`` its further options);
    returns (results, seconds, prefill seconds). The prefill is timed with a
    device sync on either side."""
    import torch

    prefill = []

    def timed(orig):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            prefill.append(time.perf_counter() - start)
            return out
        return wrapped

    torch.cuda.synchronize()
    start = time.perf_counter()
    with patched(gen, "_prefill", timed):
        results = gen.generate_batch(
            prompts, include_prompt_in_result=False, beam_size=1,
            min_length=new_tokens, max_length=new_tokens, return_scores=True,
            **kwargs)
    torch.cuda.synchronize()
    return results, time.perf_counter() - start, sum(prefill)


def generator_first_step_logprobs(gen, prompts, quantize_wrap=None,
                                  on_prefilled=None):
    """Prefill all but the last prompt token, then one decode step: its
    log-probs (float32, on the CPU). With ``quantize_wrap``,
    ``ops.linear.int8_activations`` is patched by it over both;
    ``on_prefilled`` is called between the two."""
    import torch
    import ctranslate2_tpu_torch.ops.linear as L
    from ctranslate2_tpu_torch.models import transformer as T

    m = gen.model
    if quantize_wrap is not None:
        with patched(L, "int8_activations", quantize_wrap):
            return generator_first_step_logprobs(gen, prompts,
                                                 on_prefilled=on_prefilled)
    ids = [[gen._vocab.to_id(t) for t in p] for p in prompts]
    length = len(ids[0])
    capacity = (length + GEN_NEW + 64) // 64 * 64
    m.ensure_consts(capacity)
    cache = T.init_self_cache(m.arch, len(ids), capacity, dtype=m.kv_dtype,
                              device=m.device)
    gen._prefill([row[:-1] for row in ids], cache, 0)
    if on_prefilled is not None:
        on_prefilled()
    last = torch.tensor([[row[-1]] for row in ids], dtype=torch.long, device=m.device)
    logits, _ = T.decoder_forward(
        m.arch, m.params, m.consts, last, length - 1, cache,
        quantize_acts=m.policy.quantize_activations, out_dtype=m.out_dtype)
    return torch.log_softmax(logits[:, -1].float(), -1).cpu()


def same_prefix_rows(a, b, n):
    return sum(x.sequences_ids[0][:n] == y.sequences_ids[0][:n] for x, y in zip(a, b))


def generator_main_path(tt, mf, vocab, checks, logs, plain=None):
    """The Generator at full width and depth, int8 weights, int8 KV cache:
    timed calls with the launch counters zeroed before and read after, the
    profiler's busy share, the flash-off and decode-kernel-off runs fed the
    kernel run's int8 activations, then the float16-KV call. With a dict
    ``plain``, the int8-KV and float16-KV timed calls' (seconds, prefill
    seconds, token ids) go into ``plain["int8"]`` / ``plain["float16"]``."""
    import torch

    t0 = time.perf_counter()
    with environ(CT2TPU_KV_CACHE="int8"):
        gen = make_generator(tt, mf, vocab, compute_type="int8")
    torch.cuda.synchronize()
    load_seconds = time.perf_counter() - t0
    prompts = [make_prompts(vocab, GEN_PROMPT, i) for i in range(2)]
    calls = 1  # one timed call: the AWQ path below takes the time of a second

    with environ(CT2TPU_KV_CACHE="int8"):
        generate_run(gen, prompts[0])  # warm-up
        logged_before = {name: sum(d.values()) for name, d in logs.items()}
        paths, u_paths = {}, {}
        with kernel_shape_logs(logs), w4_paths_log(paths):
            torch.cuda.reset_peak_memory_stats()
            tt.reset_launches()
            runs = [generate_run(gen, p) for p in prompts[1:1 + calls]]
            counts = tt.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_logs_cover(counts, logs, logged_before, "generator", checks)
        launches = profile_launches(lambda: generate_run(gen, prompts[1], PROFILE_NEW),
                                    lambda: generate_run(gen, prompts[1], 1),
                                    PROFILE_NEW, "generator_int8", GEN_NEW)
        with environ(CT2TPU_PALLAS_NORMS="0"):
            plain_norms = generate_run(gen, prompts[1])
        layers = len(gen.model.arch.decoder.layers)
        recorded = []
        logp = generator_first_step_logprobs(gen, prompts[1],
                                             record_quantized(recorded))
        fed = {}
        for name, switch, kernel in (
                ("flash_off", "CT2TPU_FLASH", "flash_attention"),
                ("decode_kernel_off", "CT2TPU_DECODE_KERNEL", "decode_attention_int8")):
            replay = ReplayQuantized(recorded)
            # The decode kernel runs in the step only: the prefill before it
            # is the same run again and is left out of its reading.
            on_prefilled = replay.reset_stats if kernel == "decode_attention_int8" else None
            with environ(**{switch: "0"}):
                before = tt.launch_counts()[kernel]
                logp_fed = generator_first_step_logprobs(gen, prompts[1], replay,
                                                         on_prefilled)
                checks(tt.launch_counts()[kernel] == before,
                       f"generator: {switch}=0 launches no {kernel} kernel")
            fed[name] = check_fed(replay, len(recorded), logp_fed, logp, layers,
                                  f"generator int8, {name}", checks)
        del recorded, replay
    # The float16 KV cache: the same call without the int8-KV kernel.
    tt.reset_launches()
    f16_results, f16_seconds, f16_prefill = generate_run(gen, prompts[1])
    f16_counts = tt.launch_counts()
    if plain is not None:
        plain["int8"] = (runs[0][1], runs[0][2], [r.sequences_ids[0] for r in runs[0][0]])
        plain["float16"] = (f16_seconds, f16_prefill,
                            [r.sequences_ids[0] for r in f16_results])

    results = [r for run in runs for r in run[0]]
    seconds = sum(run[1] for run in runs)
    prefill = sum(run[2] for run in runs)
    tokens = sum(len(r.sequences_ids[0]) for r in results)
    checks(all(len(r.sequences_ids[0]) == GEN_NEW for r in results + f16_results),
           f"generator: every hypothesis has {GEN_NEW} tokens")
    checks(all(math.isfinite(r.scores[0]) for r in results + f16_results)
           and bool(torch.isfinite(logp).all()),
           "generator: scores and log-probs are finite")
    checks(tuple(logp.shape) == (GEN_BATCH, LLAMA["vocab"]),
           "generator: first-step log-probs have the vocabulary's width")
    checks(f16_counts["decode_attention_int8"] == 0 and f16_counts["flash_attention"] > 0,
           "generator: the float16 KV cache runs flash and no int8-KV kernel")
    checks(counts["decode_attention_int8"] == calls * GEN_NEW * layers,
           "generator: one decode launch a layer and step "
           f"({counts['decode_attention_int8']})")
    emit({"phase": "main_generator", "compute_type": gen.compute_type,
          "kv_cache": "int8", "model": dict(LLAMA, layers=layers),
          "load_seconds": load_seconds, "calls": calls, "prompts_per_call": GEN_BATCH,
          "prompt_tokens": GEN_PROMPT, "new_tokens_per_prompt": GEN_NEW,
          "target_tokens": tokens, "seconds": seconds,
          "target_tokens_per_s": tokens / seconds,
          "prefill_ms_per_call": prefill / calls * 1e3,
          "prefill_tokens_per_s": calls * GEN_BATCH * (GEN_PROMPT - 1) / prefill,
          "decode_ms_per_step": (seconds - prefill) / calls / GEN_NEW * 1e3,
          "launches": counts,
          "launches_per_call": {k: v / calls for k, v in counts.items()},
          "peak_memory_bytes": peak,
          "profiled_launches": launches,
          "plain_norms_call": {"seconds": plain_norms[1],
                               "prefill_ms": plain_norms[2] * 1e3,
                               "decode_ms_per_step":
                                   (plain_norms[1] - plain_norms[2]) / GEN_NEW * 1e3},
          "float16_kv_call": {"seconds": f16_seconds,
                              "prefill_ms": f16_prefill * 1e3,
                              "decode_ms_per_step":
                                  (f16_seconds - f16_prefill) / GEN_NEW * 1e3,
                              "launches": f16_counts},
          "fed_kernel_runs_int8_activations": fed,
          "fed_tolerances": {"max_step": 1, "worst_linear_share": FED_STEP_SHARE,
                             "first_step_logprob": LOGPROB_TOL}})
    return counts, gen


def generator_ab(tt, mf, vocab, checks):
    """Same widths, 2 layers, no activation quantization: each attention
    kernel against the plain path it replaces, in float32 and in float16."""
    prompts = make_prompts(vocab, GEN_PROMPT, 7)
    arms = {  # environment of each arm
        "plain": dict(CT2TPU_FLASH="0"),
        "flash": {},
        "kv_plain": dict(CT2TPU_KV_CACHE="int8", CT2TPU_DECODE_KERNEL="0"),
        "kv_kernel": dict(CT2TPU_KV_CACHE="int8"),
    }
    pairs = {"flash": ("flash", "plain", "flash_attention"),
             "decode_kernel": ("kv_kernel", "kv_plain", "decode_attention_int8")}
    runs = {}
    for compute_type in ("float32", "float16"):
        gen = make_generator(tt, mf, vocab, compute_type=compute_type)
        for arm, env in arms.items():
            with environ(**env):
                tt.reset_launches()
                results = generate_run(gen, prompts, AB_NEW)[0]
                logp = generator_first_step_logprobs(gen, prompts)
                runs[compute_type, arm] = (results, logp, tt.launch_counts())
        del gen
    out = {"phase": "generator_ab", "layers": AB_LAYERS,
           "prompt_tokens": GEN_PROMPT, "own_error_factor": OWN_ERROR_FACTOR}
    for compute_type in ("float32", "float16"):
        for name, (on_arm, off_arm, kernel) in pairs.items():
            on, logp_on, counts_on = runs[compute_type, on_arm]
            off, logp_off, counts_off = runs[compute_type, off_arm]
            diff = (logp_on - logp_off).abs().max().item()
            same = same_prefix_rows(on, off, AB_NEW)
            entry = {"first_step_logprob_max_abs_diff": diff,
                     f"rows_with_same_first_{AB_NEW}_tokens": f"{same}/{GEN_BATCH}",
                     "launches_on": counts_on[kernel]}
            if compute_type == "float32":
                tol = LOGPROB_TOL
            else:
                # float16's own error on the plain path of this pair.
                own = (logp_off - runs["float32", off_arm][1]).abs().max().item()
                entry["float16_own_error"] = own
                tol = OWN_ERROR_FACTOR * own
            entry["tolerance"] = tol
            label = f"{compute_type} A/B, {name} kernel on/off"
            checks(counts_on[kernel] > 0 and counts_off[kernel] == 0,
                   f"{label}: the switch turns the kernel off "
                   f"({counts_on[kernel]} launches on, {counts_off[kernel]} off)")
            checks(diff <= tol,
                   f"{label}: first-step log-probs within {tol} (got {diff})")
            checks(same == GEN_BATCH,
                   f"{label}: the same first {AB_NEW} tokens on every row "
                   f"({same}/{GEN_BATCH})")
            out[f"{compute_type}_{name}"] = entry
    emit(out)


def generator_card_vs_cpu(tt, generators, vocab, checks):
    """The port on the card against the port on the CPU (``generators``,
    from ``card_cpu_generators``): 2 layers, same widths, float32,
    ``flash_attention=True`` so that the shorter prompts still take the
    (float32) flash kernel on the card; with the float KV cache and with
    the int8 one."""
    prompts = make_prompts(vocab, CPU_PROMPT, 9)
    card, cpu = generators
    logp, counts = {}, {}
    t0 = time.perf_counter()
    for kv in ("", "int8"):
        with environ(CT2TPU_KV_CACHE=kv):
            tt.reset_launches()
            logp["card", kv] = generator_first_step_logprobs(card, prompts)
            counts[kv] = tt.launch_counts()
            logp["cpu", kv] = generator_first_step_logprobs(cpu, prompts)
    seconds = time.perf_counter() - t0
    norms = 2 * (2 * AB_LAYERS + 1)
    checks(counts[""]["flash_attention"] == AB_LAYERS
           and counts[""]["fused_norm"] == norms
           and counts["int8"]["decode_attention_int8"] == AB_LAYERS
           and counts["int8"]["flash_attention"] == AB_LAYERS,
           f"generator card vs CPU: the card ran the kernels ({counts})")
    diff = (logp["card", ""] - logp["cpu", ""]).abs().max().item()
    checks(diff <= LOGPROB_TOL,
           f"generator card vs CPU (float32, float KV, {AB_LAYERS} layers) "
           f"first-step log-probs within {LOGPROB_TOL} (got {diff})")
    diff8 = (logp["card", "int8"] - logp["cpu", "int8"]).abs().max().item()
    own8 = (logp["cpu", "int8"] - logp["cpu", ""]).abs().max().item()
    checks(diff8 <= INT8_KV_LOGPROB_TOL,
           f"generator card vs CPU (float32, int8 KV): first-step log-probs "
           f"within {INT8_KV_LOGPROB_TOL} (got {diff8})")
    emit({"phase": "generator_card_vs_cpu", "layers": AB_LAYERS,
          "compute_type": "float32", "prompt_tokens": CPU_PROMPT,
          "float_kv_first_step_logprob_max_abs_diff": diff, "tolerance": LOGPROB_TOL,
          "int8_kv_first_step_logprob_max_abs_diff": diff8,
          "int8_kv_own_error_cpu": own8,
          "int8_kv_tolerance": INT8_KV_LOGPROB_TOL,
          "card_launches": counts["int8"], "seconds": seconds})


# ---------------------------------------------------------------------------
# Generator on AWQ-W4 weights.
# ---------------------------------------------------------------------------

W4_PLAIN = ("matmul_w4a16_plain", "matmul_w4p_plain", "matmul_w4a16_fold_plain",
            "matmul_w4p_fold_plain")


@contextlib.contextmanager
def w4_plain_calls_on_card(counter):
    """Counts, in ``counter[0]``, the calls of the four W4 plain versions
    with CUDA activations; on the main path there must be none."""
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q

    def wrap(orig):
        def wrapped(x, *args):
            counter[0] += x.is_cuda
            return orig(x, *args)
        return wrapped

    with contextlib.ExitStack() as stack:
        for name in W4_PLAIN:
            stack.enter_context(patched(Q, name, wrap))
        yield counter


@contextlib.contextmanager
def w4_paths_log(log):
    """Counts, in ``log``, the W4 kernel launches per (form, M, K, N, path
    of the plan that ran)."""
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q

    def wrap(orig):
        def wrapped(x, w, g_scale, g_zs, packed, fold, plan):
            name = ("matmul_w4p" if packed else "matmul_w4a16") + ("_fold" if fold else "")
            key = (name, x.shape[0], x.shape[1], w.shape[1], plan.path)
            log[key] = log.get(key, 0) + 1
            return orig(x, w, g_scale, g_zs, packed, fold, plan)
        return wrapped

    with patched(Q, "_w4_run", wrap):
        yield log


def check_w4_paths(log, name, checks):
    """The prefill's W4 products (M = batch x prompt) ran the wgmma path at
    the four Llama (K, N), the decode's (M = batch) split-K."""
    prefill_m = GEN_BATCH * (GEN_PROMPT - 1)
    paths = {f"{n} M {M} K {K} N {N}": path for (n, M, K, N, path) in sorted(log)}
    emit({"phase": "w4_paths", "kernel": name, "paths": paths,
          "launches": {f"{n} M {M} K {K} N {N} {path}": c
                       for (n, M, K, N, path), c in sorted(log.items())}})
    prefill = {}
    for (n, M, K, N, path) in log:
        if n == name and M == prefill_m:
            prefill.setdefault((K, N), set()).add(path)
    checks(set(prefill) == set(W4_CROSSOVER_KN)
           and all(p == {"wgmma"} for p in prefill.values()),
           f"{name}: the prefill's four shapes ran the wgmma path ({prefill})")
    decode = {path for (n, M, K, N, path) in log if n == name and M == GEN_BATCH}
    checks(decode == {"splitk"}, f"{name}: the decode steps ran split-K ({decode})")


def generator_awq_main_path(tt, mf, vocab, checks, logs):
    """The Generator on the AWQ model at full width and depth: float16
    activations (the default for an AWQ model on the card), int8 KV cache,
    the packed W4 layout (the card's default). Timed calls with the launch
    counters zeroed before and read after, the profiler's busy share; then
    one call with ``CT2TPU_W4_PACKED=0`` (the unpacked layout)."""
    import torch

    prompts = [make_prompts(vocab, GEN_PROMPT, 20 + i) for i in range(3)]
    calls = 2
    on_card = [0]
    with environ(CT2TPU_KV_CACHE="int8"), w4_plain_calls_on_card(on_card):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = make_generator(tt, mf, vocab)
        torch.cuda.synchronize()
        load_seconds = time.perf_counter() - t0
        load_peak = torch.cuda.max_memory_allocated()
        ffn = gen.model.params["decoder"]["layers"][0]["ffn"]["linear_0"]
        checks(gen.compute_type == "float16" and "w4p" in ffn,
               f"awq generator: float16 activations and packed W4 on the card "
               f"({gen.compute_type}, {sorted(ffn)})")
        generate_run(gen, prompts[0])  # warm-up
        logged_before = {name: sum(d.values()) for name, d in logs.items()}
        paths, u_paths = {}, {}
        with kernel_shape_logs(logs), w4_paths_log(paths):
            torch.cuda.reset_peak_memory_stats()
            tt.reset_launches()
            runs = [generate_run(gen, p) for p in prompts[1:1 + calls]]
            counts = tt.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        check_logs_cover(counts, logs, logged_before, "awq generator", checks)
        launches = profile_launches(lambda: generate_run(gen, prompts[1], PROFILE_NEW),
                                    lambda: generate_run(gen, prompts[1], 1),
                                    PROFILE_NEW, "generator_awq", GEN_NEW)
        with environ(CT2TPU_PALLAS_NORMS="0"):
            plain_norms = generate_run(gen, prompts[1])
        del gen
        free_card()
        with environ(CT2TPU_W4_PACKED="0"):
            gen = make_generator(tt, mf, vocab)
            ffn = gen.model.params["decoder"]["layers"][0]["ffn"]["linear_0"]
            checks("w4" in ffn, f"CT2TPU_W4_PACKED=0 loads the unpacked layout ({sorted(ffn)})")
            logged_before = {name: sum(d.values()) for name, d in logs.items()}
            with kernel_shape_logs(logs), w4_paths_log(u_paths):
                tt.reset_launches()
                unpacked = generate_run(gen, prompts[1])
                u_counts = tt.launch_counts()
            check_logs_cover(u_counts, logs, logged_before, "awq generator unpacked", checks)
        del gen
        free_card()

    expected = {k: v * calls for k, v in AWQ_LAUNCHES_PER_CALL.items() if k != "w4"}
    expected.update(matmul_w4p=AWQ_LAUNCHES_PER_CALL["w4"] * calls, matmul_w4a16=0)
    checks(all(counts[k] == v for k, v in expected.items()),
           f"awq generator: launches {counts}, expected {expected}")
    u_expected = {k: v for k, v in AWQ_LAUNCHES_PER_CALL.items() if k != "w4"}
    u_expected.update(matmul_w4a16=AWQ_LAUNCHES_PER_CALL["w4"], matmul_w4p=0)
    checks(all(u_counts[k] == v for k, v in u_expected.items()),
           f"awq generator unpacked: launches {u_counts}, expected {u_expected}")
    checks(on_card[0] == 0, f"awq generator: no W4 plain version ran on the card "
           f"({on_card[0]} calls)")
    check_w4_paths(paths, "matmul_w4p", checks)
    check_w4_paths(u_paths, "matmul_w4a16", checks)
    results = [r for run in runs for r in run[0]] + unpacked[0]
    checks(all(len(r.sequences_ids[0]) == GEN_NEW for r in results),
           f"awq generator: every hypothesis has {GEN_NEW} tokens")
    checks(all(math.isfinite(r.scores[0]) for r in results),
           "awq generator: scores are finite")
    seconds = sum(run[1] for run in runs)
    prefill = sum(run[2] for run in runs)
    tokens = sum(len(r.sequences_ids[0]) for run in runs for r in run[0])
    emit({"phase": "main_generator_awq", "compute_type": "float16",
          "kv_cache": "int8", "w4_layout": "packed (w4p)",
          "model": dict(LLAMA, layers=AWQ_LAYERS, awq_group=AWQ_GROUP),
          "load_seconds": load_seconds, "load_peak_memory_bytes": load_peak,
          "calls": calls, "prompts_per_call": GEN_BATCH, "prompt_tokens": GEN_PROMPT,
          "new_tokens_per_prompt": GEN_NEW, "target_tokens": tokens,
          "seconds": seconds, "target_tokens_per_s": tokens / seconds,
          "prefill_ms_per_call": prefill / calls * 1e3,
          "prefill_tokens_per_s": calls * GEN_BATCH * (GEN_PROMPT - 1) / prefill,
          "decode_ms_per_step": (seconds - prefill) / calls / GEN_NEW * 1e3,
          "launches": counts, "launches_per_call": {k: v / calls for k, v in counts.items()},
          "peak_memory_bytes": peak,
          "profiled_launches": launches,
          "plain_norms_call": {"seconds": plain_norms[1],
                               "prefill_ms": plain_norms[2] * 1e3,
                               "decode_ms_per_step":
                                   (plain_norms[1] - plain_norms[2]) / GEN_NEW * 1e3},
          "unpacked_call": {"seconds": unpacked[1], "prefill_ms": unpacked[2] * 1e3,
                            "decode_ms_per_step": (unpacked[1] - unpacked[2]) / GEN_NEW * 1e3,
                            "note": "one call, no warm-up", "launches": u_counts}})
    return counts, u_counts


def w4_library(x, q, s, z, ref):
    """(name, fn) of one PyTorch call that computes ``x @ ((q - z) * s)``:
    ``torch._weight_int4pack_mm`` (bfloat16 activations, its own packed
    layout, ``w = (q - 8) * s + zero'``, so zero' = (8 - z) * s), checked
    against ``ref``; where that call is missing or refuses the shape,
    unpack + dequantize + ``torch.matmul``."""
    import torch
    from ctranslate2_tpu_torch.kernels.quant_matmul import _w4p_values

    K, N = q.shape
    G = K // s.shape[0]
    try:
        qt = q.t().contiguous().to(torch.int32)
        w = torch._convert_weight_to_int4pack((qt[:, ::2] << 4 | qt[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([s, (8 - z) * s], -1).to(torch.bfloat16).contiguous()
        xb = x.to(torch.bfloat16)
        y = torch._weight_int4pack_mm(xb, w, G, sz).float()
        rel = ((y - ref).norm() / ref.norm()).item()
        if rel < 2e-2:  # bfloat16 activations and scales
            return "torch._weight_int4pack_mm", lambda: torch._weight_int4pack_mm(xb, w, G, sz)
        emit({"library_disagrees": [x.shape[0], K, N], "relative_error": rel})
    except (AttributeError, RuntimeError, TypeError) as e:
        emit({"library_refused": [x.shape[0], K, N], "error": str(e)[:200]})
    w4p = (q[:K // 2] | (q[K // 2:] << 4)).view(torch.int8)
    s_rows, zs_rows = s.repeat_interleave(G, 0), (z * s).repeat_interleave(G, 0)
    return "unpack + dequantize + torch.matmul", lambda: torch.matmul(
        x, (_w4p_values(w4p) * s_rows - zs_rows).to(x.dtype))


def w4_path_plans(Q, args, packed, fold):
    """The plan ``w4_plan`` picks for these operands of a W4 form
    (``matmul_w4p`` / ``matmul_w4a16``, or with ``fold`` their folded
    forms), and the plans of every path that can run them (``Q.W4_PATHS``:
    split-K and wgmma in a half type with an aligned payload and N % 16 ==
    0, the tile always); folded, also the wgmma block of the x rows the
    plan's rule does not pick (``wgmma_<rows>``: the wide block's
    evidence)."""
    import torch

    x, w, s = args[:3]
    chosen = Q.w4_wrapper_plan(x, w, s, packed, fold)
    M, K = x.shape
    N = w.shape[1]
    fast = x.dtype != torch.float32 and w.data_ptr() % 16 == 0 and N % 16 == 0
    G = K // s.shape[0]
    plans = {path: Q.w4_path_plan(path, M, N, K, G, packed, fold)
             for path in Q.W4_PATHS if fast or path == "tile"}
    if fold and fast:
        rows = Q.W4_WGMMA_WIDE_ROWS + Q.W4_WGMMA_TILE[0] - plans["wgmma"].mt
        plans[f"wgmma_{rows}"] = Q.w4_path_plan("wgmma", M, N, K, G, packed, fold, rows)
    return chosen, plans


def w4_run_form(Q, args, packed, fold, plan):
    """One W4 form on ``plan``'s path, as its wrapper computes it: for
    ``matmul_w4p_fold`` the product, then its zero-point term."""
    if not (packed and fold):
        return Q._w4_run(*args[:3], args[3] if packed else None, packed, fold, plan)
    return Q._w4p_sub_zero_term(Q._w4_run(*args[:3], None, True, True, plan), args[0], args[3])


def w4_operands(g, M, K, N, dt):
    """Random W4 operands on the card (AutoAWQ-like: nibbles, scales in
    [0.005, 0.0075], zero points 7-8): q [K, N] and z as drawn, and the
    packed and unpacked payloads made from them."""
    import torch

    G = AWQ_GROUP
    x = torch.randn((M, K), generator=g, device="cuda").to(getattr(torch, dt))
    q = torch.randint(0, 16, (K, N), generator=g, device="cuda", dtype=torch.uint8)
    s = torch.rand((K // G, N), generator=g, device="cuda") * 0.0025 + 0.005
    z = torch.randint(7, 9, (K // G, N), generator=g, device="cuda").float()
    operands = {True: (x, (q[:K // 2] | (q[K // 2:] << 4)).view(torch.int8), s, z * s),
                False: (x, (q.to(torch.int16) - z.to(torch.int16).repeat_interleave(G, 0))
                        .to(torch.int8), s)}
    return x, q, s, z, operands


def w4_paths_ms(Q, name, args, packed, fold, ref, bound, iters, checks, skip=()):
    """Every path that can run these operands (``w4_path_plans``), except
    those in ``skip``: each held to ``bound`` against ``ref`` and timed.
    Returns the chosen plan and {path: ms}, {path: worst share of the
    bound}."""
    chosen, plans = w4_path_plans(Q, args, packed, fold)
    times, worst = {}, {}
    for path, plan in plans.items():
        if path in skip:
            continue
        diff = (w4_run_form(Q, args, packed, fold, plan) - ref).abs()
        worst[path] = (diff / bound).max().item()
        checks(bool((diff <= bound).all()),
               f"{name} {path} path within its error bound of plain at "
               f"{tuple(args[0].shape)} x {tuple(args[1].shape)} "
               f"(worst share of the bound {worst[path]})")
        del diff
        times[path] = cuda_time_ms(lambda: w4_run_form(Q, args, packed, fold, plan), iters)
    return chosen, times, worst


def bench_w4(shapes, checks):
    """The four W4 kernels at every main-path shape, against their plain
    versions within ``w4_error_bound``, with the plain version's time, the
    library call's and the bound. ``shapes`` holds the shape logs of
    ``matmul_w4p`` (packed calls) and ``matmul_w4a16`` (the unpacked call);
    the two folded forms are not on the path and run at their counterpart's
    shapes, their sums weighted by its launches. Each line also carries its
    plan (path, split count) and the times of the paths the plan did not
    pick, each held to the same bound: the crossover's evidence;
    ``matmul_w4p_fold``'s also the time of its zero-point term alone (its
    ``kernel_ms`` holds the product and the term). Returns the sums."""
    import torch
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q

    kinds = {name: (packed, fold, name.replace("_fold", ""))  # the path's kernel
             for name, packed, fold in W4_FORMS}
    g = torch.Generator(device="cuda").manual_seed(6)
    G = AWQ_GROUP
    tots = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
                       max_abs_err=0.0, libraries=set()) for name in kinds}
    for key in sorted(set(shapes["matmul_w4p"]) | set(shapes["matmul_w4a16"])):
        M, K, N, dt = key
        x, q, s, z, operands = w4_operands(g, M, K, N, dt)
        small = M * K * N < 2 ** 32
        iters, plain_iters = (50, 10) if small else (3, 2)
        library, lib_fn = w4_library(x, q, s, z, Q.matmul_w4a16_plain(*operands[False]))
        lib_ms = cuda_time_ms(lib_fn, iters)
        for name, (packed, fold, base) in kinds.items():
            n = shapes[base].get(key, 0)
            fn, plain = getattr(Q, name), getattr(Q, name + "_plain")
            args = operands[packed]
            zs = args[3] if packed else None
            out = fn(*args)
            ref = plain(*args)
            bound = Q.w4_error_bound(*args[:3], zs, fold)
            torch.cuda.synchronize()
            diff = (out - ref).abs()
            err = diff.max().item()
            worst = (diff / bound).max().item()
            checks(bool((diff <= bound).all()),
                   f"{name} within its error bound of plain at {key} "
                   f"(max abs err {err}, worst share of the bound {worst})")
            # The other paths at the same shape, held to the same bound: the
            # crossover's evidence.
            plan, paths_ms, paths_worst = w4_paths_ms(
                Q, name, args, packed, fold, ref, bound, iters, checks,
                skip=(Q.w4_wrapper_plan(x, args[1], s, packed, fold).path,))
            del out, ref, diff, bound
            ms = cuda_time_ms(lambda: fn(*args), iters)
            extra = {}
            if packed and fold:
                part = torch.empty((M, N), dtype=torch.float32, device="cuda")
                extra["zero_term_ms"] = cuda_time_ms(
                    lambda: Q._w4p_sub_zero_term(part, x, args[3]), iters)
                del part
            plain_ms = cuda_time_ms(lambda: plain(*args), plain_iters)
            nbytes = ((K * N // 2 + 8 * (K // G) * N) if packed else (K * N + 4 * (K // G) * N)) \
                + M * K * x.element_size() + 4 * M * N
            bytes_ms = nbytes / PEAK_BYTES * 1e3
            ops_ms = 2 * M * N * K / (PEAK_F32_FLOPS if dt == "float32" else PEAK_HALF_FLOPS) * 1e3
            emit({"phase": "kernel_w4", "kernel": name, "M": M, "K": K, "N": N, "dtype": dt,
                  "group": G, "launches": n if name == base else 0,
                  "weighted_by_launches_of": base, "weight": n,
                  "path": plan.path, "rows": plan.mt, "splits": plan.splits,
                  "k_chunk": plan.k_chunk,
                  "other_paths_ms": paths_ms,
                  "other_paths_worst_share_of_error_bound": paths_worst,
                  "max_abs_err": err, "worst_share_of_error_bound": worst,
                  "kernel_ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  "library": library, "bytes_moved": nbytes,
                  "tflops": 2 * M * N * K / ms / 1e9, "gbytes_per_s": nbytes / ms / 1e6,
                  "bound_ms": max(bytes_ms, ops_ms), "share_of_bound": max(bytes_ms, ops_ms) / ms,
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", **extra})
            tot = tots[name]
            tot["ms"] += n * ms
            tot["plain_ms"] += n * plain_ms
            tot["library_ms"] += n * lib_ms
            tot["bytes_ms"] += n * bytes_ms
            tot["ops_ms"] += n * ops_ms
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            tot["libraries"].add(library)
        del x, q, operands
        free_card()
    for tot in tots.values():
        tot["libraries"] = sorted(tot["libraries"])
    return tots


def bench_w4_crossover(checks):
    """Each path of the four W4 forms at every (M, K, N) of
    ``W4_CROSSOVER_MS`` x ``W4_CROSSOVER_KN`` in float16, held to
    ``w4_error_bound`` and timed; one line a shape with the plan's path and
    the fastest path."""
    import torch
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q

    g = torch.Generator(device="cuda").manual_seed(9)
    rows = []
    for K, N in W4_CROSSOVER_KN:
        for M in W4_CROSSOVER_MS:
            x, q, s, z, operands = w4_operands(g, M, K, N, "float16")
            iters = 20 if M * K * N < 2 ** 33 else 3
            for name, packed, fold in W4_FORMS:
                args = operands[packed]
                zs = args[3] if packed else None
                ref = getattr(Q, name + "_plain")(*args)
                bound = Q.w4_error_bound(*args[:3], zs, fold)
                plan, times, worst = w4_paths_ms(Q, name, args, packed, fold, ref, bound,
                                                 iters, checks)
                del ref, bound
                fastest = None if _UNTIMED else min(times, key=times.get)
                ops_ms = 2 * M * N * K / PEAK_HALF_FLOPS * 1e3
                emit({"phase": "w4_crossover", "kernel": name, "M": M, "K": K, "N": N,
                      "dtype": "float16", "group": AWQ_GROUP, "plan_path": plan.path,
                      "plan_rows": plan.mt,
                      "fastest_path": fastest, "paths_ms": times,
                      "worst_share_of_error_bound": worst, "ops_bound_ms": ops_ms,
                      "tflops": {p: 2 * M * N * K / ms / 1e9 for p, ms in times.items()}})
                rows.append((name, M, K, N, plan.path, fastest))
            del x, q, operands
            free_card()
    return rows


def generator_awq_checks(tt, mf, vocab, checks):
    """2 layers of the AWQ model, packed and unpacked. The card in float32
    (the W4 kernels' FMA path) against the port on the CPU (their plain
    versions): first-step log-probs within ``LOGPROB_TOL``. Then the card in
    float16 (the ``mma`` path), the W4 kernel against its plain version
    patched in its place: first-step log-probs within ``OWN_ERROR_FACTOR``
    times float16's own error on the same path (its plain run against the
    float32 plain run), and the same first 8 tokens on every row."""
    import torch
    import ctranslate2_tpu_torch.ops.linear as L
    from ctranslate2_tpu_torch.kernels import quant_matmul as Q

    out = {"phase": "generator_awq_checks", "layers": AB_LAYERS,
           "cpu_prompt_tokens": AWQ_CPU_PROMPT, "float16_prompt_tokens": GEN_PROMPT,
           "own_error_factor": OWN_ERROR_FACTOR}
    cpu_prompts = make_prompts(vocab, AWQ_CPU_PROMPT, 11)
    prompts = make_prompts(vocab, GEN_PROMPT, 12)
    for packed, kernel, other in (("1", "matmul_w4p", "matmul_w4a16"),
                                  ("0", "matmul_w4a16", "matmul_w4p")):
        plain = getattr(Q, kernel + "_plain")
        def as_plain():
            return patched(L, kernel, lambda orig: plain)

        with environ(CT2TPU_W4_PACKED=packed):
            card = make_generator(tt, mf, vocab, compute_type="float32", flash_attention=True)
            tt.reset_launches()
            logp_card = generator_first_step_logprobs(card, cpu_prompts)
            counts = tt.launch_counts()
            cpu = make_generator(tt, mf, vocab, device="cpu", compute_type="float32",
                                 flash_attention=True)
            logp_cpu = generator_first_step_logprobs(cpu, cpu_prompts)
            del cpu
            with as_plain():  # the float32 reference of float16's own error
                logp32 = generator_first_step_logprobs(card, prompts)
            del card
            free_card()
            gen = make_generator(tt, mf, vocab, compute_type="float16")
            runs = {}
            for arm in ("kernel", "plain"):
                with as_plain() if arm == "plain" else contextlib.nullcontext():
                    tt.reset_launches()
                    results = generate_run(gen, prompts, AB_NEW)[0]
                    logp = generator_first_step_logprobs(gen, prompts)
                    runs[arm] = (results, logp, tt.launch_counts()[kernel])
            del gen
            free_card()
        diff = (logp_card - logp_cpu).abs().max().item()
        label = f"awq card vs CPU (float32, {kernel}, {AB_LAYERS} layers)"
        checks(counts[kernel] == 2 * 5 * AB_LAYERS and counts[other] == 0,
               f"{label}: every W4 linear launched {kernel} ({counts})")
        checks(bool(torch.isfinite(logp_card).all()) and diff <= LOGPROB_TOL,
               f"{label}: first-step log-probs within {LOGPROB_TOL} (got {diff})")
        (k_res, k_logp, k_n), (p_res, p_logp, p_n) = runs["kernel"], runs["plain"]
        own = (p_logp - logp32).abs().max().item()
        diff16 = (k_logp - p_logp).abs().max().item()
        same = same_prefix_rows(k_res, p_res, AB_NEW)
        tol = OWN_ERROR_FACTOR * own
        label = f"awq float16, {kernel} against its plain version ({AB_LAYERS} layers)"
        checks(k_n > 0 and p_n == 0,
               f"{label}: the kernel run launched it, the plain run did not ({k_n}, {p_n})")
        checks(diff16 <= tol, f"{label}: first-step log-probs within {tol} (got {diff16})")
        checks(same == GEN_BATCH, f"{label}: the same first {AB_NEW} tokens on every row "
               f"({same}/{GEN_BATCH})")
        out[f"float32_card_vs_cpu_{kernel}"] = {
            "first_step_logprob_max_abs_diff": diff, "tolerance": LOGPROB_TOL,
            "launches": counts[kernel]}
        out[f"float16_kernel_vs_plain_{kernel}"] = {
            "first_step_logprob_max_abs_diff": diff16, "float16_own_error": own,
            "tolerance": tol, f"rows_with_same_first_{AB_NEW}_tokens": f"{same}/{GEN_BATCH}",
            "launches": k_n}
    emit(out)


# ---------------------------------------------------------------------------
# Teacher-forced entry points, the Encoder and random sampling.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def plain_calls_on_card(counter):
    """Counts, in ``counter[name]``, the calls of every kernel's plain version
    with a CUDA tensor (where a wrapper or the model code looks it up); on a
    main path there must be none."""
    import ctranslate2_tpu_torch.kernels.decode_attention as DA
    import ctranslate2_tpu_torch.kernels.flash_attention as FA
    import ctranslate2_tpu_torch.kernels.gather_rows as GR
    import ctranslate2_tpu_torch.kernels.norms as KN
    import ctranslate2_tpu_torch.kernels.quant_matmul as Q
    import ctranslate2_tpu_torch.ops.norms as N

    homes = [(Q, "matmul_w8a8_plain"), (FA, "flash_attention_plain"),
             (DA, "decode_attention_int8_plain"), (GR, "gather_rows_plain"),
             (KN, "fused_norm_plain"), (N, "fused_norm_plain")]
    homes += [(Q, name) for name in W4_PLAIN]

    def wrap(name):
        def outer(orig):
            def wrapped(x, *args, **kwargs):
                first = x[0] if isinstance(x, (list, tuple)) else x
                if first.is_cuda:
                    with LOG_LOCK:
                        counter[name] = counter.get(name, 0) + 1
                return orig(x, *args, **kwargs)
            return wrapped
        return outer

    with contextlib.ExitStack() as stack:
        for module, name in homes:
            stack.enter_context(patched(module, name, wrap(name)))
        yield counter


@contextlib.contextmanager
def watched(logs, plain):
    """The kernels' call shapes into ``logs`` and their plain versions' calls
    on the card into ``plain``, with the launch counters zeroed first."""
    import torch
    import ctranslate2_tpu_torch as tt

    with kernel_shape_logs(logs), plain_calls_on_card(plain):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tt.reset_launches()
        yield


def synced_seconds(call):
    """(result, seconds) of one call, on the host's clock with the card
    synced on either side."""
    import torch

    torch.cuda.synchronize()
    start = time.perf_counter()
    out = call()
    torch.cuda.synchronize()
    return out, time.perf_counter() - start


def check_path(label, counts, kernels, plain, checks):
    for name in kernels:
        checks(counts[name] > 0, f"{label}: {name} launched ({counts[name]})")
    checks(not plain, f"{label}: no plain version ran on the card ({plain})")


def score_generator(tt, gen, vocab, checks, logs):
    """``Generator.score_batch`` on the 4 prompts of 2,049 tokens at the
    int8 Llama geometry (every prompt teacher-forced over 2,055 padded
    positions: causal flash with per-row lengths, the W8A8 projection at
    M 8,220 and N 128,256), then ``forward_batch(return_log_probs=True)``
    on the same prompts, whose gathered log-probs must equal the scores."""
    import torch

    prompts = make_prompts(vocab, GEN_PROMPT, 1)
    kw = dict(max_input_length=GEN_PROMPT)  # the default, 1,024, would cut them
    gen.score_batch(prompts, **kw)  # warm-up
    plain = {}
    with watched(logs, plain):
        scores, seconds = synced_seconds(lambda: gen.score_batch(prompts, **kw))
        counts = tt.launch_counts()
        score_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        lp, fwd_seconds = synced_seconds(
            lambda: gen.forward_batch(prompts, return_log_probs=True))
        fwd_peak = torch.cuda.max_memory_allocated()
        total = tt.launch_counts()
    shape = tuple(lp.shape)
    ids = torch.tensor([[vocab.to_id(t) for t in p] for p in prompts], device=lp.device)
    gathered = lp[:, :GEN_PROMPT - 1].gather(-1, ids[:, 1:, None])[..., 0].cpu()
    del lp
    ref = torch.tensor([s.tokens_score for s in scores])
    diff = (gathered - ref).abs().max().item()
    tokens = GEN_BATCH * (GEN_PROMPT - 1)
    layers = len(gen.model.arch.decoder.layers)
    checks(tuple(ref.shape) == (GEN_BATCH, GEN_PROMPT - 1) and bool(torch.isfinite(ref).all()),
           f"score_generator: {GEN_PROMPT - 1} finite scores a row ({tuple(ref.shape)})")
    checks(shape == (GEN_BATCH, GEN_PROMPT + 7, LLAMA["vocab"]),
           f"score_generator: forward_batch's log-probs [{GEN_BATCH}, {GEN_PROMPT + 7}, "
           f"{LLAMA['vocab']}] ({shape})")
    checks(diff <= LOGPROB_TOL,
           f"score_generator: forward_batch's gathered log-probs equal score_batch's "
           f"within {LOGPROB_TOL} (got {diff})")
    checks(counts["flash_attention"] == layers and counts["fused_norm"] == 2 * layers + 1
           and counts["matmul_w8a8"] == 5 * layers + 1,
           f"score_generator: one flash launch a layer, one norm a block and the output "
           f"norm, five W8A8 a layer and the projection ({counts})")
    check_path("score_generator", total, ("flash_attention", "matmul_w8a8", "fused_norm"),
               plain, checks)
    emit({"phase": "score_generator", "compute_type": gen.compute_type,
          "prompts": GEN_BATCH, "prompt_tokens": GEN_PROMPT, "scored_tokens": tokens,
          "score_batch_seconds": seconds, "scored_tokens_per_s": tokens / seconds,
          "forward_batch_seconds": fwd_seconds,
          "forward_batch_tokens_per_s": GEN_BATCH * GEN_PROMPT / fwd_seconds,
          "launches_per_score_call": counts,
          "launches_both_calls": total,
          "peak_memory_bytes_score_batch": score_peak,
          "peak_memory_bytes_forward_batch": fwd_peak,
          "forward_batch_vs_score_batch_max_abs_diff": diff, "tolerance": LOGPROB_TOL,
          "plain_calls_on_card": plain})


def score_translator(tt, model_dir, batch, checks, logs):
    """``Translator.score_batch`` on the int8 Transformer-base model: the 64
    sources of a phase-2 batch, each against its own beam-2 translation
    (32 tokens; scored with the EOS, 33)."""
    import torch

    tr = tt.Translator(model_dir, compute_type="int8")
    targets = [r.hypotheses[0] for r in tr.translate_batch(batch, **OPTS)]
    tr.score_batch(batch, targets)  # warm-up
    plain = {}
    with watched(logs, plain):
        results, seconds = synced_seconds(lambda: tr.score_batch(batch, targets))
        counts = tt.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    scores = [s for r in results for s in r.tokens_score]
    tokens = len(scores)
    checks(len(results) == BATCH and all(
               r.tokens == t + ["</s>"] for r, t in zip(results, targets))
           and tokens == BATCH * (MAX_DEC + 1) and all(math.isfinite(s) for s in scores),
           f"score_translator: {BATCH} results of {MAX_DEC + 1} finite scores")
    check_path("score_translator", counts, ("matmul_w8a8", "fused_norm"), plain, checks)
    emit({"phase": "score_translator", "compute_type": tr.compute_type,
          "sources": BATCH, "scored_tokens": tokens, "seconds": seconds,
          "scored_tokens_per_s": tokens / seconds, "launches": counts,
          "peak_memory_bytes": peak, "plain_calls_on_card": plain})


def build_bert_modelfile(layers):
    """The BERT-base geometry (``BERT``) in a new in-memory ModelFile: float16
    weights drawn from per-matrix seeds, LayerNorm gammas around 1."""
    import numpy as np
    from ctranslate2_tpu_torch.converters.builder import ACTIVATION_IDS
    from ctranslate2_tpu_torch.formats.model_file import ModelFile, make_variable

    d, ff = BERT["d_model"], BERT["d_ff"]
    mf = ModelFile(spec_name="TransformerEncoderSpec", spec_revision=1, binary_version=6)
    mf.config = {"unk_token": "[UNK]", "bos_token": "[CLS]", "eos_token": "[SEP]",
                 "layer_norm_epsilon": 1e-12}

    def add(name, value, dtype=None):
        mf.variables[name] = make_variable(name, value, dtype)

    sc = "encoder"
    add(f"{sc}/num_heads", BERT["heads"], "int16")
    add(f"{sc}/pre_norm", 0, "int8")
    # What the converter writes for BERT's hidden_act "gelu".
    add(f"{sc}/activation", ACTIVATION_IDS["gelu_tanh"], "int8")
    add(f"{sc}/embeddings_merge", 1, "int8")
    add(f"{sc}/scale_embeddings", 0, "int8")
    add("pooler_activation", ACTIVATION_IDS["tanh"], "int8")
    jobs = [(f"{sc}/embeddings_0/weight", (BERT["vocab"], d), 0.5),
            (f"{sc}/embeddings_1/weight", (BERT["types"], d), 0.5),
            (f"{sc}/position_encodings/encodings", (BERT["positions"], d), 0.5),
            ("pooler_dense/weight", (d, d), 0.05), ("pooler_dense/bias", (d,), 0.05)]
    norms = [f"{sc}/layernorm_embedding"]
    for i in range(layers):
        ls = f"{sc}/layer_{i}"
        for scope, out_dim, in_dim in ((f"{ls}/self_attention/linear_0", 3 * d, d),
                                       (f"{ls}/self_attention/linear_1", d, d),
                                       (f"{ls}/ffn/linear_0", ff, d),
                                       (f"{ls}/ffn/linear_1", d, ff)):
            jobs += [(f"{scope}/weight", (out_dim, in_dim), 0.05),
                     (f"{scope}/bias", (out_dim,), 0.05)]
        norms += [f"{ls}/self_attention/layer_norm", f"{ls}/ffn/layer_norm"]
    for seed, (name, shape, scale) in enumerate(jobs):
        rng = np.random.default_rng(100 + seed)
        add(name, (rng.standard_normal(shape, dtype=np.float32) * scale).astype(
            np.float16 if len(shape) == 2 else np.float32))
    for seed, scope in enumerate(norms):
        rng = np.random.default_rng(5000 + seed)
        add(f"{scope}/gamma", 1.0 + rng.standard_normal(d, dtype=np.float32) * 0.05)
        add(f"{scope}/beta", rng.standard_normal(d, dtype=np.float32) * 0.05)
    return mf


def encoder_subset(mf, layers):
    """The first ``layers`` layers of a fabricated encoder, sharing its arrays."""
    from ctranslate2_tpu_torch.formats.model_file import ModelFile

    sub = ModelFile(spec_name=mf.spec_name, spec_revision=mf.spec_revision,
                    binary_version=mf.binary_version)
    sub.config = dict(mf.config)
    for name, var in mf.variables.items():
        layer = re.match(r"encoder/layer_(\d+)/", name)
        if not layer or int(layer.group(1)) < layers:
            sub.variables[name] = var
    return sub


def encoder_inputs(rows, longest, seed):
    """``rows`` id lists of mixed lengths up to ``longest`` (one of exactly
    ``longest``), each a sentence pair: token type 0, then 1 from its
    middle on."""
    import numpy as np

    r = np.random.default_rng(3000 + seed)
    lengths = [longest] + [int(n) for n in r.integers(longest // 2, longest + 1, rows - 1)]
    ids = [[int(t) for t in r.integers(1000, BERT["vocab"], n)] for n in lengths]
    types = [[0] * (n // 2) + [1] * (n - n // 2) for n in lengths]
    return ids, types


def encoder_phase(tt, mf, checks, logs):
    """``Encoder.forward_batch`` at the BERT-base geometry, int8 and float16:
    32 sequences of up to 128 tokens, then 8 of up to 512 with
    ``flash_attention=True`` (the flash kernel, non-causal, per-row
    lengths, head dim 64)."""
    import torch

    out = {}
    for compute_type in ("int8", "float16"):
        for rows, longest, flash in ENC_SHAPES:
            enc = tt.Encoder(mf, compute_type=compute_type, flash_attention=flash)
            ids, types = encoder_inputs(rows, longest, rows)
            enc.forward_batch(ids, token_type_ids=types)  # warm-up
            plain = {}
            with watched(logs, plain):
                res, seconds = synced_seconds(
                    lambda: enc.forward_batch(ids, token_type_ids=types))
                counts = tt.launch_counts()
                peak = torch.cuda.max_memory_allocated()
            label = f"encoder {compute_type} {rows}x{longest}"
            h, pooled = res.last_hidden_state, res.pooler_output
            checks(tuple(h.shape) == (rows, longest, BERT["d_model"])
                   and tuple(pooled.shape) == (rows, BERT["d_model"])
                   and bool(torch.isfinite(h).all()) and bool(torch.isfinite(pooled).all()),
                   f"{label}: finite last_hidden_state and pooler_output of the right shapes")
            kernels = ["fused_norm"] + (["matmul_w8a8"] if compute_type == "int8" else [])
            check_path(label, counts, kernels + (["flash_attention"] if flash else []),
                       plain, checks)
            checks(counts["flash_attention"] == (BERT["layers"] if flash else 0)
                   and counts["fused_norm"] == 2 * BERT["layers"] + 1,
                   f"{label}: flash {'on' if flash else 'off'}, 25 norms ({counts})")
            tokens = sum(len(i) for i in ids)
            out[f"{compute_type}_{rows}x{longest}"] = {
                "flash_attention_flag": flash, "sequences": rows, "tokens": tokens,
                "seconds": seconds, "sequences_per_s": rows / seconds,
                "tokens_per_s": tokens / seconds, "padded_tokens": rows * longest,
                "launches": counts, "peak_memory_bytes": peak,
                "plain_calls_on_card": plain}
            del enc, res, h, pooled
            free_card()
    emit({"phase": "encoder", "model": BERT, **out})


def sampling_generator(tt, gen, vocab, checks, logs):
    """Sampled ``generate_batch`` at the int8 Llama geometry with the int8 KV
    cache: top-k 50, temperature 0.8, twice with one seed (the same tokens)
    and once with another (other tokens)."""
    prompts = make_prompts(vocab, GEN_PROMPT, 3)
    kw = dict(max_length=SAMPLE_NEW, sampling_topk=50, sampling_temperature=0.8,
              include_prompt_in_result=False, return_scores=True)
    plain = {}
    with environ(CT2TPU_KV_CACHE="int8"), watched(logs, plain):
        runs = [synced_seconds(lambda: gen.generate_batch(prompts, seed=seed, **kw))
                for seed in (1, 1, 2)]
        counts = tt.launch_counts()
    ids = [[r.sequences_ids[0] for r in run] for run, _ in runs]
    tokens = sum(len(i) for i in ids[0])
    checks(ids[0] == ids[1], "sampling: two calls with one seed give the same tokens")
    checks(ids[0] != ids[2], "sampling: another seed gives other tokens")
    checks(all(0 < len(i) <= SAMPLE_NEW for run in ids for i in run)
           and all(math.isfinite(r.scores[0]) for run, _ in runs for r in run),
           "sampling: every row sampled, with finite scores")
    check_path("sampling generator", counts, ("decode_attention_int8", "matmul_w8a8",
                                              "flash_attention", "fused_norm"), plain, checks)
    return {"layers": len(gen.model.arch.decoder.layers),
            "prompts": GEN_BATCH, "new_tokens": tokens, "calls": len(runs),
            "seconds_per_call": [sec for _, sec in runs],
            "sampled_tokens_per_s": tokens / runs[0][1], "launches_three_calls": counts,
            "plain_calls_on_card": plain}


def sampling_translator(tt, model_dir, batch, checks, logs):
    """Beam 2 with ``sampling_topk=10`` on the int8 Translator, chain mask on
    and off. As in the JAX package, beam search takes the best candidates
    whatever the sampler: both calls must give the argmax beam's
    hypotheses."""
    tr = tt.Translator(model_dir, compute_type="int8")
    opts = dict(OPTS, sampling_topk=10)
    argmax = tr.translate_batch(batch, **OPTS)
    plain = {}
    with watched(logs, plain):
        chain, seconds = synced_seconds(lambda: tr.translate_batch(batch, **opts))
        chain_counts = tt.launch_counts()
        with chain_off():
            off = tr.translate_batch(batch, **opts)
        counts = tt.launch_counts()
    hyps = [[r.hypotheses for r in res] for res in (argmax, chain, off)]
    checks(hyps[1] == hyps[0], "sampling translator: beam + top-k 10 gives the argmax beam")
    checks(compare_chain(chain, off)["identical"] == len(batch),
           "sampling translator: chain-off gives the chain run's hypotheses")
    gather = counts["gather_rows_fused"] - chain_counts["gather_rows_fused"]
    checks(gather > 0, f"sampling translator: the chain-off call launched the gather "
                       f"kernel ({gather})")
    check_path("sampling translator", counts, ("matmul_w8a8", "fused_norm"), plain, checks)
    return {"sentences": len(batch), "beam": BEAM, "sampling_topk": 10,
            "chain_call_seconds": seconds, "gather_launches_chain_off": gather,
            "launches": counts, "plain_calls_on_card": plain}


def sampler_frequencies(checks):
    """``sample_tokens`` on the card with the card's own noise:
    ``SAMPLE_ROWS`` draws from one ``SAMPLE_VOCAB``-word distribution under
    ``SAMPLE_OPTS``. Each word's count within ``FREQ_SIGMAS`` standard
    errors of its truncated, renormalized probability
    (``sampling.truncated_probabilities``); no word outside the nucleus."""
    import numpy as np
    import torch
    from ctranslate2_tpu_torch.decoding import sampling

    g = torch.Generator(device="cuda").manual_seed(10)
    lp = torch.log_softmax(torch.randn(SAMPLE_VOCAB, generator=g, device="cuda") * 2.0, -1)
    expected = sampling.truncated_probabilities(lp.cpu().numpy(), **SAMPLE_OPTS)
    rows = SAMPLE_ROWS
    batch = lp.expand(rows, SAMPLE_VOCAB).contiguous()
    noise = sampling.noise_source(11, "cuda")
    shape = sampling.sample_noise_shape(rows, SAMPLE_VOCAB, SAMPLE_OPTS["topk"])
    ids, _ = sampling.sample_tokens(batch, noise(0, shape, "cuda"), **SAMPLE_OPTS)
    counts = np.bincount(ids.cpu().numpy(), minlength=SAMPLE_VOCAB)
    inside = expected > 0
    sd = np.sqrt(rows * expected * (1 - expected))
    z = np.abs(counts - rows * expected)[inside] / sd[inside]
    outside = int(counts[~inside].sum())
    checks(outside == 0 and z.max() <= FREQ_SIGMAS,
           f"sampling frequencies (sample_tokens): every word within {FREQ_SIGMAS} "
           f"standard errors (worst {z.max()}), none outside the nucleus ({outside})")
    return {"nucleus_words": int(inside.sum()),
            "sample_tokens": {"worst_standard_errors": float(z.max()),
                              "drawn_outside": outside}}


def sampling_phase(tt, gen, vocab, model_dir, batch, checks, logs):
    t0 = time.perf_counter()
    out = {"generator": sampling_generator(tt, gen, vocab, checks, logs),
           "translator_beam": sampling_translator(tt, model_dir, batch, checks, logs),
           "frequencies": sampler_frequencies(checks)}
    emit({"phase": "sampling", **out, "seconds": time.perf_counter() - t0})


def card_cpu_generators(tt, mf, vocab):
    """The ``AB_LAYERS``-layer Llama in float32 with ``flash_attention=True``
    on the card and on the CPU, shared by the card-against-CPU phases."""
    return (make_generator(tt, mf, vocab, compute_type="float32", flash_attention=True),
            make_generator(tt, mf, vocab, device="cpu", compute_type="float32",
                           flash_attention=True))


def teacher_forced_card_vs_cpu(tt, generators, vocab, bert, checks):
    """At ``AB_LAYERS`` layers, float32, the card against the port on the
    CPU (``generators``, from ``card_cpu_generators``): ``score_batch`` and
    ``forward_batch`` (2 prompts of ``CPU_PROMPT``, flash forced on by
    ``flash_attention=True``), the Encoder's hidden states and pooler (8
    sequences of up to 128, flash on), and a sampled ``generate_batch``
    with both fed the same noise (drawn on the CPU)."""
    import torch
    from ctranslate2_tpu_torch.decoding import sampling

    t0 = time.perf_counter()
    prompts = make_prompts(vocab, CPU_PROMPT, 11)[:2]
    card, cpu = generators
    tt.reset_launches()
    scores = card.score_batch(prompts, max_input_length=CPU_PROMPT)
    lp_card = card.forward_batch(prompts, return_log_probs=True).cpu()
    counts = tt.launch_counts()
    lp_cpu = cpu.forward_batch(prompts, return_log_probs=True)
    ids = torch.tensor([[vocab.to_id(t) for t in p] for p in prompts])
    gathered = lp_cpu[:, :CPU_PROMPT - 1].gather(-1, ids[:, 1:, None])[..., 0]
    score_diff = (torch.tensor([s.tokens_score for s in scores]) - gathered).abs().max().item()
    fwd_diff = (lp_card - lp_cpu).abs().max().item()
    del lp_card, lp_cpu
    checks(counts["flash_attention"] == 2 * AB_LAYERS and counts["fused_norm"] > 0,
           f"teacher-forced card vs CPU: the card ran flash and the norm ({counts})")
    checks(score_diff <= LOGPROB_TOL and fwd_diff <= LOGPROB_TOL,
           f"teacher-forced card vs CPU: score_batch ({score_diff}) and forward_batch "
           f"({fwd_diff}) within {LOGPROB_TOL}")

    # A sampled call, both sides fed the same noise.
    shared = sampling.noise_source

    def same_noise(seed, device):
        cpu_noise = shared(seed, "cpu")
        return lambda step, shape, dev: cpu_noise(step, shape, "cpu").to(dev)

    short = [p[:33] for p in make_prompts(vocab, 33, 12)]
    kw = dict(max_length=AB_NEW, sampling_topk=50, sampling_temperature=0.8,
              include_prompt_in_result=False, return_scores=True, seed=5)
    with patched(sampling, "noise_source", lambda orig: same_noise):
        sampled = [g.generate_batch(short, **kw) for g in (card, cpu)]
    same = sum(a.sequences_ids == b.sequences_ids for a, b in zip(*sampled))
    checks(same == len(short),
           f"sampled generate card vs CPU, fed the same noise: token-identical "
           f"({same}/{len(short)})")

    enc_card = tt.Encoder(bert, compute_type="float32", flash_attention=True)
    enc_cpu = tt.Encoder(bert, device="cpu", compute_type="float32")
    ids, types = encoder_inputs(8, 128, 13)
    tt.reset_launches()
    a = enc_card.forward_batch(ids, token_type_ids=types)
    enc_counts = tt.launch_counts()
    b = enc_cpu.forward_batch(ids, token_type_ids=types)
    h_diff = (a.last_hidden_state.cpu() - b.last_hidden_state).abs().max().item()
    p_diff = (a.pooler_output.cpu() - b.pooler_output).abs().max().item()
    checks(enc_counts["flash_attention"] == AB_LAYERS and enc_counts["fused_norm"] > 0,
           f"encoder card vs CPU: the card ran flash and the norm ({enc_counts})")
    checks(h_diff <= LOGPROB_TOL and p_diff <= LOGPROB_TOL,
           f"encoder card vs CPU: hidden states ({h_diff}) and pooler ({p_diff}) "
           f"within {LOGPROB_TOL}")
    emit({"phase": "teacher_forced_card_vs_cpu", "layers": AB_LAYERS,
          "compute_type": "float32", "prompt_tokens": CPU_PROMPT,
          "score_batch_max_abs_diff": score_diff, "forward_batch_max_abs_diff": fwd_diff,
          "sampled_rows_identical": f"{same}/{len(short)}",
          "encoder_hidden_max_abs_diff": h_diff, "encoder_pooler_max_abs_diff": p_diff,
          "tolerance": LOGPROB_TOL, "card_launches": counts,
          "encoder_card_launches": enc_counts, "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# The host decode loops.
# ---------------------------------------------------------------------------


def write_vmap(model_dir, sources, vocab):
    """A ``vmap.txt`` whose rules cover the tokens of ``sources``: each
    proposes ``VMAP_TARGETS`` words drawn from one pool of ``VMAP_POOL``, so
    a sentence of 20-30 tokens gets about 3,700 candidates and a batch at
    most the pool (with <unk>, <s> and </s>)."""
    import numpy as np

    rng = np.random.default_rng(21)
    pool = rng.choice(np.arange(3, len(vocab)), VMAP_POOL, replace=False)
    with open(os.path.join(model_dir, "vmap.txt"), "w", encoding="utf-8") as f:
        for token in sorted({t for s in sources for t in s}):
            targets = rng.choice(pool, VMAP_TARGETS, replace=False)
            f.write(token + "\t" + " ".join(vocab.to_token(int(t)) for t in targets)
                    + "\n")


def same_hypotheses(host, device, label, checks):
    """``compare_chain``'s rule (``CHAIN_SAME_SHARE["int8"]``, ``SCORE_TOL``)
    for a host-loop call against the device loop's call on the same batch."""
    cmp = compare_chain(host, device)
    checks(cmp["identical"] >= CHAIN_SAME_SHARE["int8"] * cmp["sentences"]
           and cmp["best_score_max_abs_diff"] <= SCORE_TOL,
           f"{label}: the device loop's hypotheses ({cmp['identical']}/"
           f"{cmp['sentences']} identical, best-score diff "
           f"{cmp['best_score_max_abs_diff']})")
    return cmp


def unknowns_restored(host, device, sources, label, checks):
    """``replace_unknowns``: the host call's hypotheses are the device
    loop's with every <unk> replaced by a source token. Returns the host
    results with those tokens put back to <unk> (for ``same_hypotheses``)
    and the count of replaced tokens."""
    import copy

    restored, replaced, ok = [], 0, True
    for h, d, src in zip(host, device, sources):
        r = copy.copy(h)
        r.hypotheses = []
        for hyp, dev in zip(h.hypotheses, d.hypotheses + [None] * len(h.hypotheses)):
            back = list(hyp)
            for t, tok in enumerate(hyp):
                if dev is not None and t < len(dev) and dev[t] == "<unk>":
                    ok &= tok in src
                    back[t] = "<unk>"
                    replaced += 1
            r.hypotheses.append(back)
        restored.append(r)
    checks(ok and not any("<unk>" in hyp for h in host for hyp in h.hypotheses),
           f"{label}: every <unk> replaced by a source token ({replaced})")
    return restored, replaced


def attention_checks(results, sources, label, checks):
    """Attention rows: one a target token, non-negative, the source's
    length, each summing to 1 within 1e-3."""
    worst, ok = 0.0, True
    for r, src in zip(results, sources):
        ok &= len(r.attention) == len(r.hypotheses)
        for hyp, attn in zip(r.hypotheses, r.attention):
            ok &= len(attn) == len(hyp) and all(len(row) == len(src) for row in attn)
            for row in attn:
                ok &= min(row) >= 0
                worst = max(worst, abs(sum(row) - 1.0))
    checks(ok and worst <= 1e-3,
           f"{label}: attention rows non-negative, of the source's length, summing "
           f"to 1 within 1e-3 (worst {worst})")
    return worst


def count_delta(after, before):
    return {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}


def host_loop_translator(tt, model_dir, vocab, batch, checks, logs):
    """The int8 Transformer-base Translator's host loops on the 64 sentences
    of a phase-2 batch (``OPTS``: beam 2, 32 target tokens), one timed call
    of each option, beside the device loop's call (chain mask on, and off)
    in the same run."""
    import numpy as np

    write_vmap(model_dir, batch, vocab)
    tr = tt.Translator(model_dir, compute_type="int8")
    greedy = dict(OPTS, beam_size=1)
    device, device_s = synced_seconds(lambda: tr.translate_batch(batch, **OPTS))
    with chain_off():
        device_off, device_off_s = synced_seconds(lambda: tr.translate_batch(batch, **OPTS))
    device_greedy, device_greedy_s = synced_seconds(
        lambda: tr.translate_batch(batch, **greedy))
    bias_prefix = [h.hypotheses[0][:HOST_BIAS_PREFIX] for h in device]
    alt_batch = batch[:HOST_ALT_SENTENCES]
    alt_prefix = [h.hypotheses[0][:HOST_ALT_PREFIX] for h in device[:HOST_ALT_SENTENCES]]
    steps = []

    def callback(step):
        steps.append((step.batch_id, step.step, step.token, step.is_last))

    calls = {  # name: (sentences, target prefix, options)
        "attention": (batch, None, dict(OPTS, return_attention=True,
                                        replace_unknowns=True)),
        "coverage": (batch, None, dict(OPTS, coverage_penalty=0.2)),
        "prefix_bias": (batch, bias_prefix, dict(OPTS, prefix_bias_beta=0.5)),
        "logits": (batch, None, dict(OPTS, return_logits_vocab=True)),
        "alternatives": (alt_batch, alt_prefix, dict(
            OPTS, return_alternatives=True, num_hypotheses=HOST_ALT_HYPOTHESES)),
        "vmap": (batch, None, dict(OPTS, use_vmap=True)),
        "callback": (batch, None, dict(greedy, callback=callback)),
    }
    plain, results, out = {}, {}, {}
    with watched(logs, plain):
        for name, (sentences, prefix, opts) in calls.items():
            before = tt.launch_counts()
            results[name], seconds = synced_seconds(
                lambda: tr.translate_batch(sentences, prefix, **opts))
            tokens = sum(len(h) for r in results[name] for h in r.hypotheses)
            out[name] = {"sentences": len(sentences), "seconds": seconds,
                         "target_tokens": tokens,
                         "target_tokens_per_s": tokens / seconds,
                         "launches": count_delta(tt.launch_counts(), before)}
        total = tt.launch_counts()
    os.remove(os.path.join(model_dir, "vmap.txt"))

    label = "host_loop_translator"
    for name in ("attention", "coverage", "prefix_bias", "logits", "alternatives"):
        checks(out[name]["launches"].get("gather_rows_fused", 0) > 0,
               f"{label} {name}: the beam call launched the gather kernel "
               f"({out[name]['launches'].get('gather_rows_fused', 0)})")
    attn = results["attention"]
    restored, out["attention"]["unknowns_replaced"] = unknowns_restored(
        attn, device_off, batch, f"{label} attention", checks)
    out["attention"]["vs_device_loop"] = same_hypotheses(
        restored, device_off, f"{label} attention", checks)
    out["attention"]["attention_row_sum_worst_abs_diff"] = attention_checks(
        attn, batch, f"{label} attention", checks)
    out["logits"]["vs_device_loop"] = same_hypotheses(
        results["logits"], device_off, f"{label} logits", checks)
    widths = {tuple(np.asarray(l).shape) for r in results["logits"]
              for ls in r.logits for l in ls}
    checks(widths == {(MODEL["vocab_size"],)}
           and all(len(ls) == 1 for r in results["logits"] for ls in r.logits)
           and all(len(r.logits) == len(r.hypotheses) for r in results["logits"]),
           f"{label} logits: one vocabulary-wide vector a hypothesis, its last step "
           f"({widths})")
    out["callback"]["vs_device_loop"] = same_hypotheses(
        results["callback"], device_greedy, f"{label} callback", checks)
    emitted = sum(len(r.hypotheses[0]) for r in results["callback"])
    lasts = sorted((b, s) for b, s, _, last in steps if last)
    row_ends = sorted((b, max(s for bb, s, _, _ in steps if bb == b))
                      for b in {b for b, _, _, _ in steps})
    checks(len(steps) == emitted and lasts == row_ends and len(lasts) == len(batch),
           f"{label} callback: one callback a token ({len(steps)} for {emitted}), "
           f"is_last on each row's last")
    checks(all(len(r.hypotheses[0]) == MAX_DEC and math.isfinite(r.scores[0])
               for name in ("coverage", "prefix_bias", "vmap") for r in results[name]),
           f"{label}: coverage, prefix-bias and vmap calls give {MAX_DEC} tokens and "
           f"finite scores")
    alt_ok = True
    for r, p in zip(results["alternatives"], alt_prefix):
        alt_ok &= len(r.hypotheses) == HOST_ALT_HYPOTHESES and all(
            h[:len(p)] == p for h in r.hypotheses)
        alt_ok &= len({h[len(p)] for h in r.hypotheses}) == len(r.hypotheses)
    checks(alt_ok, f"{label} alternatives: {HOST_ALT_HYPOTHESES} a sentence, each "
                   f"starting with its prefix, all parting right after it")
    sentence_candidates = [len(tr._vmap.get_candidates([s])) for s in batch]
    allowed = set(tr._vmap.get_candidates(batch))
    used = {vocab.to_id(t) for r in results["vmap"] for h in r.hypotheses for t in h}
    checks(used <= allowed, f"{label} vmap: every token a candidate "
                            f"({len(used - allowed)} outside)")
    out["vmap"].update(candidates_per_sentence=[min(sentence_candidates),
                                                max(sentence_candidates)],
                       candidates_call=len(allowed),
                       projection_width=-(-len(allowed) // 256) * 256)
    out["prefix_bias"]["rows_keeping_the_prefix"] = sum(
        r.hypotheses[0][:HOST_BIAS_PREFIX] == p for r, p in zip(results["prefix_bias"],
                                                                 bias_prefix))
    check_path(label, total, ("matmul_w8a8", "fused_norm", "gather_rows_fused"), plain,
               checks)
    tokens = BATCH * MAX_DEC
    emit({"phase": label, "compute_type": tr.compute_type, "sentences": BATCH,
          "beam": BEAM, "target_tokens_per_call": tokens,
          "device_loop": {"chain_seconds": device_s, "chain_tokens_per_s": tokens / device_s,
                          "chain_off_seconds": device_off_s,
                          "chain_off_tokens_per_s": tokens / device_off_s,
                          "greedy_seconds": device_greedy_s,
                          "greedy_tokens_per_s": tokens / device_greedy_s},
          "calls": out, "launches": total, "plain_calls_on_card": plain})


def host_loop_generator(tt, gen, vocab, checks, logs):
    """The int8 Llama's host loops with the int8 KV cache: a callback's
    greedy call against the device loop's (4 x 2,049, 64 new tokens), every
    step's vocabulary logits for 8 tokens, a static prompt of 2,048 tokens
    before 4 prompts of 64 (two calls, the second on the cached prompt) and
    the alternatives of one prompt."""
    import numpy as np

    prompts = make_prompts(vocab, GEN_PROMPT, 4)
    sp = make_prompts(vocab, GEN_PROMPT - 1, 5)[0]
    short = make_prompts(vocab, 64, 6)
    steps = []
    label = "host_loop_generator"
    plain, out = {}, {}
    with environ(CT2TPU_KV_CACHE="int8"), watched(logs, plain):
        def run(name, call):
            before = tt.launch_counts()
            result = call()
            out[name] = {"launches": count_delta(tt.launch_counts(), before)}
            return result

        device, device_s, device_prefill = run("device_loop", lambda: generate_run(
            gen, prompts))
        host, host_s, host_prefill = run("callback", lambda: generate_run(
            gen, prompts, callback=lambda r: steps.append((r.batch_id, r.is_last))))
        for name, sec, pre in (("device_loop", device_s, device_prefill),
                               ("callback", host_s, host_prefill)):
            out[name].update(seconds=sec, prefill_ms=pre * 1e3,
                             decode_ms_per_step=(sec - pre) / GEN_NEW * 1e3)
        logits, out_logits = run("logits", lambda: synced_seconds(lambda: gen.generate_batch(
            prompts, include_prompt_in_result=False, max_length=AB_NEW,
            min_length=AB_NEW, return_logits_vocab=True)))
        out["logits"]["seconds"] = out_logits
        ttft = []
        for i in range(2):
            res, sec = run(f"static_prompt_{i + 1}", lambda: synced_seconds(
                lambda: gen.generate_batch(short, static_prompt=sp, max_length=1,
                                           include_prompt_in_result=False)))
            ttft.append((res, sec))
            out[f"static_prompt_{i + 1}"]["time_to_first_token_ms"] = sec * 1e3
        alts, alt_s = run("alternatives", lambda: synced_seconds(lambda: gen.generate_batch(
            prompts[:1], include_prompt_in_result=False, max_length=16,
            return_alternatives=True, num_hypotheses=HOST_ALT_HYPOTHESES)))
        out["alternatives"]["seconds"] = alt_s
        total = tt.launch_counts()

    layers = len(gen.model.arch.decoder.layers)
    same = sum(a.sequences_ids == b.sequences_ids for a, b in zip(host, device))
    checks(same == GEN_BATCH, f"{label}: the callback's call gives the device loop's "
                              f"tokens ({same}/{GEN_BATCH})")
    checks(len(steps) == GEN_BATCH * GEN_NEW
           and sorted(b for b, last in steps if last) == list(range(GEN_BATCH)),
           f"{label}: one callback a token ({len(steps)}), is_last once a row")
    for name in ("device_loop", "callback"):
        checks(out[name]["launches"].get("decode_attention_int8", 0) == GEN_NEW * layers,
               f"{label} {name}: one decode launch a layer and step")
    shapes = {tuple(np.asarray(l).shape) for r in logits for ls in r.logits for l in ls}
    checks(shapes == {(LLAMA["vocab"],)}
           and all(len(r.logits[0]) == AB_NEW for r in logits)
           and all(bool(np.isfinite(np.asarray(l)).all()) for r in logits
                   for l in r.logits[0]),
           f"{label} logits: {AB_NEW} finite vocabulary-wide vectors a row ({shapes})")
    first, second = (out[f"static_prompt_{i}"]["launches"] for i in (1, 2))
    checks(first.get("flash_attention", 0) == layers
           and second.get("flash_attention", 0) == 0,
           f"{label} static prompt: the first call prefills it through flash "
           f"({first.get('flash_attention', 0)}), the second reuses it (no flash: "
           f"{second.get('flash_attention', 0)})")
    checks([r.sequences_ids for r in ttft[0][0]] == [r.sequences_ids for r in ttft[1][0]],
           f"{label} static prompt: both calls give the same first tokens")
    hyps = alts[0].sequences_ids
    checks(len(hyps) == HOST_ALT_HYPOTHESES and len({h[0] for h in hyps}) == len(hyps),
           f"{label} alternatives: {HOST_ALT_HYPOTHESES}, parting at the first token")
    check_path(label, total, ("matmul_w8a8", "fused_norm", "flash_attention",
                              "decode_attention_int8"), plain, checks)
    emit({"phase": label, "compute_type": gen.compute_type, "kv_cache": "int8",
          "layers": len(gen.model.arch.decoder.layers),
          "prompts": GEN_BATCH, "prompt_tokens": GEN_PROMPT, "new_tokens": GEN_NEW,
          "static_prompt_tokens": len(sp), "static_prompt_inputs": [GEN_BATCH, 64],
          "calls": out, "callbacks": len(steps), "launches": total,
          "plain_calls_on_card": plain})


def host_loop_card_vs_cpu(tt, small_dir, generators, vocab, tvocab, batch, checks):
    """At ``AB_LAYERS`` layers, float32, every host-loop option on the card
    against the port on the CPU: the Transformer-base widths' Translator (4
    sentences) and the Llama geometry's Generator (4 prompts of 33, a static
    prompt of 64): identical hypotheses and callbacks, scores, attention
    and logits within ``LOGPROB_TOL``; the static prompt's call gives the
    first ``AB_NEW`` tokens of the call with the prompt prepended."""
    import numpy as np

    t0 = time.perf_counter()
    sentences = batch[:4]
    write_vmap(small_dir, sentences, tvocab)
    card = tt.Translator(small_dir, compute_type="float32")
    cpu = tt.Translator(small_dir, device="cpu", compute_type="float32")
    device = card.translate_batch(sentences, **OPTS)
    prefix = [h.hypotheses[0][:HOST_BIAS_PREFIX] for h in device]
    worst = {}
    label = "host_loop_card_vs_cpu"

    def close(name, a, b):
        if not a and not b:
            return
        d = max((float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
                 for x, y in zip(a, b)), default=0.0)
        worst[name] = max(worst.get(name, 0.0), d)
        checks(len(a) == len(b) and d <= LOGPROB_TOL,
               f"{label} {name}: card within {LOGPROB_TOL} of the CPU (got {d})")

    calls = {
        "attention": (None, dict(return_attention=True, replace_unknowns=True)),
        "coverage": (None, dict(coverage_penalty=0.2)),
        "prefix_bias": (prefix, dict(prefix_bias_beta=0.5)),
        "logits": (None, dict(return_logits_vocab=True)),
        "alternatives": ([p[:HOST_ALT_PREFIX] for p in prefix],
                         dict(return_alternatives=True,
                              num_hypotheses=HOST_ALT_HYPOTHESES)),
        "vmap": (None, dict(use_vmap=True)),
        "callback": (None, dict(beam_size=1)),
    }
    counts = {}
    for name, (pre, extra) in calls.items():
        streams = ([], [])
        opts = []
        for into in streams:
            opts.append(dict(OPTS, **extra))
            if name == "callback":
                opts[-1]["callback"] = lambda r, into=into: into.append(
                    (r.batch_id, r.step, r.token_id, r.is_last))
        # The CPU reference runs on its worker thread beside the card call.
        b = cpu.translate_batch(sentences, pre, asynchronous=True, **opts[1])
        tt.reset_launches()
        a = card.translate_batch(sentences, pre, **opts[0])
        counts[name] = tt.launch_counts()
        b = [r.result() for r in b]
        checks([r.hypotheses for r in a] == [r.hypotheses for r in b]
               and streams[0] == streams[1],
               f"{label} translator {name}: identical hypotheses and callbacks")
        close(f"translator {name} scores", [r.scores for r in a], [r.scores for r in b])
        close(f"translator {name} attention", [x for r in a for x in r.attention],
              [x for r in b for x in r.attention])
        close(f"translator {name} logits", [x for r in a for x in r.logits],
              [x for r in b for x in r.logits])
    os.remove(os.path.join(small_dir, "vmap.txt"))
    checks(all(counts[n]["gather_rows_fused"] > 0 for n in
               ("attention", "coverage", "prefix_bias", "logits", "alternatives")),
           f"{label}: the card's host beam calls launched the gather kernel")
    del card, cpu
    free_card()

    gcard, gcpu = generators
    prompts = [p[:33] for p in make_prompts(vocab, 33, 14)]
    sp = make_prompts(vocab, 64, 15)[0]
    kw = dict(max_length=AB_NEW, include_prompt_in_result=False, return_scores=True)
    gen_calls = {
        "callback": dict(kw),
        "logits": dict(kw, return_logits_vocab=True),
        "static_prompt": dict(kw, static_prompt=sp),
        "static_prompt_beam": dict(kw, static_prompt=sp, beam_size=2),
        "alternatives": dict(kw, return_alternatives=True,
                             num_hypotheses=HOST_ALT_HYPOTHESES),
    }
    for name, opts in gen_calls.items():
        streams = ([], [])
        both = []
        for into in streams:
            both.append(dict(opts, callback=lambda r, into=into: into.append(
                (r.batch_id, r.step, r.token_id, r.is_last))) if name == "callback" else opts)
        b = gcpu.generate_batch(prompts, asynchronous=True, **both[1])
        tt.reset_launches()
        a = gcard.generate_batch(prompts, **both[0])
        counts["generator " + name] = tt.launch_counts()
        b = [r.result() for r in b]
        checks([r.sequences_ids for r in a] == [r.sequences_ids for r in b]
               and streams[0] == streams[1],
               f"{label} generator {name}: identical tokens and callbacks")
        close(f"generator {name} scores", [r.scores for r in a], [r.scores for r in b])
        close(f"generator {name} logits", [x for r in a for x in r.logits],
              [x for r in b for x in r.logits])
    prepended = gcard.generate_batch([sp + p for p in prompts], **kw)
    cached = gcard.generate_batch(prompts, static_prompt=sp, **kw)
    same = sum(x.sequences_ids[0][:AB_NEW] == y.sequences_ids[0][:AB_NEW]
               for x, y in zip(cached, prepended))
    checks(same == len(prompts),
           f"{label} static prompt: the first {AB_NEW} tokens of the prompt prepended "
           f"on every row ({same}/{len(prompts)})")
    checks(counts["generator static_prompt"]["flash_attention"] == AB_LAYERS
           and counts["generator static_prompt_beam"]["flash_attention"] == 0,
           f"{label} static prompt: flash prefills it once, then the cache serves "
           f"({counts['generator static_prompt']['flash_attention']}, "
           f"{counts['generator static_prompt_beam']['flash_attention']})")
    emit({"phase": label, "layers": AB_LAYERS, "compute_type": "float32",
          "sentences": len(sentences), "prompts": len(prompts), "prompt_tokens": 33,
          "static_prompt_tokens": len(sp), "max_abs_diff": worst,
          "tolerance": LOGPROB_TOL,
          "static_prompt_rows_as_prepended": f"{same}/{len(prompts)}",
          "card_launches": counts, "seconds": time.perf_counter() - t0})


def new_shapes(logs, main_logs):
    """Per kernel, the call shapes of ``logs`` that no main path of
    ``main_logs`` gave it."""
    return {name: {k: n for k, n in shapes.items() if k not in main_logs.get(name, {})}
            for name, shapes in logs.items()}


def record_quantized(out):
    """A ``patched`` wrapper for ``ops.linear.int8_activations``, the one
    function every int8 activation passes (the norm kernel's and
    ``quantize_input``'s alike), that appends every (q, scale) to ``out``."""
    def wrap(orig):
        def wrapped(q, scale, dtype):
            out.append((q, scale))
            return orig(q, scale, dtype)
        return wrapped
    return wrap


class ReplayQuantized:
    """A ``patched`` wrapper for ``ops.linear.int8_activations``: it takes
    this run's int8 activations (quantized by the norm kernel or by
    ``quantize_input``), counts where they land apart from the recorded
    run's for the same linears, and passes on the recorded (q, scale),
    so that every W8A8 product gets the same int8 inputs in both runs (card
    and CPU, or a kernel and the plain path it replaces). A run that
    quantizes fewer or other activations than the recorded one leaves
    recorded pairs unused or raises."""

    def __init__(self, recorded):
        self.recorded = recorded
        self.calls = 0
        self.reset_stats()

    def reset_stats(self):
        self.entries = self.differing = self.max_step = self.calls_differing = 0
        self.worst_share = 0.0  # of one linear's entries

    def __call__(self, orig):
        def wrapped(q, scale, dtype):
            q_rec, scale_rec = self.recorded[self.calls]
            self.calls += 1
            q_rec, scale_rec = q_rec.to(q.device), scale_rec.to(q.device)
            step = (q.int() - q_rec.int()).abs()
            differing = int((step > 0).sum().item())
            self.entries += step.numel()
            self.differing += differing
            self.calls_differing += differing > 0
            self.worst_share = max(self.worst_share, differing / step.numel())
            self.max_step = max(self.max_step, int(step.max().item()))
            return orig(q_rec, scale_rec, dtype)
        return wrapped


def check_fed(replay, recorded, logp_fed, logp, layers, label, checks):
    """A switch-off run fed the kernel run's int8 activations: every layer's
    attention then sees the kernel run's inputs, and its own output is read
    where the next linear (the output projection) quantizes it. No other
    linear's input can differ, the two attentions' outputs may round an
    entry at a half step one int8 step apart, and the log-probs agree."""
    diff = (logp_fed - logp).abs().max().item()
    checks(replay.calls == recorded > 0,
           f"{label}: the same {recorded} linears quantize (got {replay.calls})")
    checks(0 < replay.calls_differing <= layers,
           f"{label}: only the {layers} attention outputs differ "
           f"({replay.calls_differing} linears with differing inputs)")
    checks(replay.max_step <= 1 and replay.worst_share <= FED_STEP_SHARE,
           f"{label}: attention outputs at most one int8 step apart on at "
           f"most {FED_STEP_SHARE} of a linear's entries (max step "
           f"{replay.max_step}, worst share {replay.worst_share})")
    checks(diff <= LOGPROB_TOL,
           f"{label}: first-step log-probs within {LOGPROB_TOL} (got {diff})")
    return {"linears_with_differing_inputs": replay.calls_differing,
            "int8_max_step": replay.max_step,
            "worst_linear_share_differing": replay.worst_share,
            "entries": replay.entries, "entries_differing": replay.differing,
            "first_step_logprob_max_abs_diff": diff}


def first_step_logprobs(tr, sentences, quantize_wrap=None):
    """The first decode step's log-probs (float32, on the CPU); with
    ``quantize_wrap``, ``ops.linear.int8_activations`` is patched by it."""
    import torch
    import ctranslate2_tpu_torch.ops.linear as L
    from ctranslate2_tpu_torch.models import transformer as T

    m = tr.model
    ids, lengths = tr._pad_feature_ids(
        tr._ids_from_streams(tr._source_feature_streams(sentences), 1024))
    qa = m.policy.quantize_activations
    consts = m.ensure_consts(64)
    patch = (patched(L, "int8_activations", quantize_wrap) if quantize_wrap
             else contextlib.nullcontext())
    with torch.no_grad(), patch:
        mem = T.encoder_forward(m.arch, m.params, consts, ids, lengths,
                                quantize_acts=qa, out_dtype=m.out_dtype)
        mem_kv = T.precompute_memory(m.arch, m.params, mem, quantize_acts=qa)
        bias = T.attn_ops.length_mask_bias(lengths, mem.shape[1])
        cache = T.init_self_cache(m.arch, len(sentences), 64,
                                  dtype=m.kv_dtype, device=m.device)
        start = torch.full((len(sentences), 1), tr._decoder_start_id(),
                           dtype=torch.long, device=m.device)
        logits, _ = T.decoder_forward(m.arch, m.params, consts, start, 0,
                                      cache, mem_kv, bias, quantize_acts=qa,
                                      out_dtype=m.out_dtype)
    return torch.log_softmax(logits[:, -1].float(), -1).cpu()


def card_vs_cpu(tt, model_dir, batch, checks):
    """The port on the card against the port on the CPU, 4 sentences."""
    sentences = batch[:4]
    opts = dict(beam_size=BEAM, max_decoding_length=MAX_DEC)
    cpu_float32 = None
    for compute_type in ("float32", "int8_float32"):
        cpu = tt.Translator(model_dir, device="cpu", compute_type=compute_type)
        card = tt.Translator(model_dir, device="cuda", compute_type=compute_type)
        recorded = []
        logp_cpu = first_step_logprobs(cpu, sentences, record_quantized(recorded))
        logp_card = first_step_logprobs(card, sentences)
        hyps = [[r.hypotheses for r in tr.translate_batch(sentences, **opts)]
                for tr in (card, cpu)]
        diff = (logp_card - logp_cpu).abs().max().item()
        out = {"phase": "card_vs_cpu", "compute_type": compute_type,
               "sentences": len(sentences), "first_step_logprob_max_abs_diff": diff,
               "identical_hypotheses": f"{sum(a == b for a, b in zip(*hyps))}"
                                       f"/{len(sentences)}"}
        if not recorded:
            cpu_float32 = logp_cpu
            checks(diff <= LOGPROB_TOL, f"card vs CPU ({compute_type}) first-step "
                   f"log-probs within {LOGPROB_TOL} (got {diff})")
            out["tolerance"] = LOGPROB_TOL
            emit(out)
            continue
        # int8: the free run above is reported only; an activation at a
        # half-step tie parts the two runs by about int8's own error.
        replay = ReplayQuantized(recorded)
        logp_fed = first_step_logprobs(card, sentences, replay)
        fed_diff = (logp_fed - logp_cpu).abs().max().item()
        share = replay.differing / max(replay.entries, 1)
        checks(replay.calls == len(recorded) > 0,
               f"card vs CPU ({compute_type}): the same {len(recorded)} linears "
               f"quantize on the card (got {replay.calls})")
        checks(fed_diff <= LOGPROB_TOL,
               f"card vs CPU ({compute_type}) fed the CPU's int8 activations: "
               f"first-step log-probs within {LOGPROB_TOL} (got {fed_diff})")
        checks(replay.max_step <= 1 and share < QUANT_DIFF_SHARE,
               f"card vs CPU ({compute_type}): the card's own int8 activations are "
               f"at most one step from the CPU's on under {QUANT_DIFF_SHARE} of "
               f"the entries (max step {replay.max_step}, share {share})")
        out.update({
            "fed_cpu_int8_logprob_max_abs_diff": fed_diff, "tolerance": LOGPROB_TOL,
            "int8_linears": len(recorded), "int8_entries": replay.entries,
            "int8_entries_differing": replay.differing,
            "int8_max_step": replay.max_step,
            # int8's own error: the same int8 weights on the CPU with and
            # without quantizing activations.
            "int8_vs_float32_cpu_logprob_max_abs_diff":
                (logp_cpu - cpu_float32).abs().max().item()})
        emit(out)


# ---------------------------------------------------------------------------
# Conversion without JAX: checkpoints fabricated with torch and numpy,
# converted through the port's CLI, loaded on the card.
# ---------------------------------------------------------------------------

# The converted models: 2 layers at Transformer-base's widths.
CONVERT = dict(layers=2, d_model=512, heads=8, d_ff=2048, vocab=MODEL["vocab_size"])
CONVERT_SENTENCES = 8
CONVERT_TIMEOUT = 300  # seconds for the fabricating and converting subprocess
# The subprocess's interpreter: ``jax`` and the JAX package fail to import.
NO_JAX = """
import sys

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ctranslate2_tpu"):
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, _Blocked())
"""
# Fabricates an OpenNMT-py checkpoint (torch.save) and a Marian ``.npz``
# with its vocabulary, and converts both through the port's CLI: OpenNMT-py
# with ``--quantization int8``, Marian without. Argument: the directory.
CONVERT_SCRIPT = NO_JAX + """
import os
import time
started = time.perf_counter()
import numpy as np
import torch
import yaml
from ctranslate2_tpu_torch.cli import convert

work = sys.argv[1]
L, D, H, FF, V = %(layers)d, %(d_model)d, %(heads)d, %(d_ff)d, %(vocab)d
rng = np.random.default_rng(31)

def r(*shape):
    return (rng.standard_normal(shape) * D ** -0.5).astype(np.float32)

def ones():
    return np.ones(D, np.float32)

def zeros():
    return np.zeros(D, np.float32)

words = ["<unk>", "<blank>", "<s>", "</s>"] + [f"tok{i}" for i in range(V - 4)]
model = {}
for side, layers in (("encoder", "encoder.transformer"), ("decoder", "decoder.transformer_layers")):
    model[f"{side}.embeddings.make_embedding.emb_luts.0.weight"] = r(V, D)
    model[f"{side}.embeddings.make_embedding.pe.pe"] = r(1024, 1, D)
    model[f"{side}.layer_norm.weight"], model[f"{side}.layer_norm.bias"] = ones(), zeros()
    for i in range(L):
        scopes = ["self_attn"] + (["context_attn"] if side == "decoder" else [])
        for a in scopes:
            for part in ("linear_query", "linear_keys", "linear_values", "final_linear"):
                model[f"{layers}.{i}.{a}.{part}.weight"] = r(D, D)
                model[f"{layers}.{i}.{a}.{part}.bias"] = r(D)
        f = f"{layers}.{i}.feed_forward"
        model[f"{f}.w_1.weight"], model[f"{f}.w_1.bias"] = r(FF, D), r(FF)
        model[f"{f}.w_2.weight"], model[f"{f}.w_2.bias"] = r(D, FF), r(D)
        model[f"{f}.layer_norm.weight"], model[f"{f}.layer_norm.bias"] = ones(), zeros()
        norms = ["layer_norm"] if side == "encoder" else ["layer_norm_1", "layer_norm_2"]
        for n in norms:
            model[f"{layers}.{i}.{n}.weight"], model[f"{layers}.{i}.{n}.bias"] = ones(), zeros()
onmt = os.path.join(work, "onmt.pt")
torch.save({"model": {k: torch.from_numpy(v) for k, v in model.items()},
            "generator": {"weight": torch.from_numpy(r(V, D)), "bias": torch.from_numpy(r(V))},
            "opt": {"decoder_type": "transformer", "encoder_type": "transformer", "heads": H,
                    "position_encoding": True, "pos_ffn_activation_fn": "relu"},
            "vocab": {"src": words, "tgt": words}}, onmt)

config = {"type": "transformer", "transformer-decoder-autoreg": "self-attention",
          "transformer-no-projection": False, "transformer-ffn-activation": "relu",
          "transformer-preprocess": "", "transformer-postprocess": "dan",
          "transformer-postprocess-emb": "d", "transformer-heads": H, "enc-depth": L,
          "dec-depth": L, "transformer-guided-alignment-layer": "last"}
arrays = {"special:model.yml": np.frombuffer(yaml.dump(config).encode() + b"\\x00", np.int8),
          "Wemb": r(V, D), "decoder_ff_logit_out_b": r(1, V)}
for side in ("encoder", "decoder"):
    for i in range(1, L + 1):
        for a in ["self"] + (["context"] if side == "decoder" else []):
            s = f"{side}_l{i}_{a}"
            for n in "qkvo":
                arrays[f"{s}_W{n}"], arrays[f"{s}_b{n}"] = r(D, D), r(1, D)
            arrays[f"{s}_Wo_ln_scale"], arrays[f"{s}_Wo_ln_bias"] = ones()[None], zeros()[None]
        s = f"{side}_l{i}_ffn"
        arrays[f"{s}_W1"], arrays[f"{s}_b1"] = r(D, FF), r(1, FF)
        arrays[f"{s}_W2"], arrays[f"{s}_b2"] = r(FF, D), r(1, D)
        arrays[f"{s}_ffn_ln_scale"], arrays[f"{s}_ffn_ln_bias"] = ones()[None], zeros()[None]
npz, vocab = os.path.join(work, "model.npz"), os.path.join(work, "vocab.yml")
np.savez(npz, **arrays)
with open(vocab, "w", encoding="utf-8") as f:
    f.write("</s>: 0\\n<unk>: 1\\n" + "".join(f"tok{i}: {i}\\n" for i in range(2, V)))
convert.opennmt_py_main(["--model_path", onmt, "--output_dir", os.path.join(work, "onmt_int8"),
                         "--quantization", "int8"])
convert.marian_main(["--model_path", npz, "--vocab_paths", vocab, vocab,
                     "--output_dir", os.path.join(work, "marian")])
try:
    import jax
    print("JAX_IMPORTED")
except ImportError:
    pass
print("CONVERT_MODULES", sorted(m for m in sys.modules
                                if m.split(".")[0] in ("jax", "jaxlib", "ctranslate2_tpu")))
print("CONVERT_SECONDS", time.perf_counter() - started)
""" % CONVERT


def start_conversion():
    """Starts ``CONVERT_SCRIPT`` in a subprocess of its own over a new
    directory under the kernels' build directory (it needs no card: the
    script starts it beside the kernel build). Returns (the process, the
    directory)."""
    from ctranslate2_tpu_torch.kernels import build

    os.makedirs(build.build_dir(), exist_ok=True)
    directory = tempfile.mkdtemp(prefix="convert_", dir=build.build_dir())
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-c", CONVERT_SCRIPT, directory],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)

    def stop():  # however the script ends
        if proc.poll() is None:
            proc.kill()
        proc.wait()
        shutil.rmtree(directory, ignore_errors=True)

    atexit.register(stop)
    return proc, directory


def convert_and_run(tt, conversion, checks, logs):
    """``convert_and_run``: in a subprocess where ``jax`` and
    ``ctranslate2_tpu`` cannot be imported, an OpenNMT-py checkpoint and a
    Marian ``.npz`` (``CONVERT``: 2 layers at Transformer-base's widths)
    fabricated with torch and numpy and converted through the port's
    ``cli/convert.py`` (OpenNMT-py with ``--quantization int8``); each
    directory loaded by the port's ``Translator`` on the card and on the
    CPU, ``translate_batch`` at beam 2 on ``CONVERT_SENTENCES`` sentences
    with the chain mask off (the beam reorders through the gather kernel).
    The float Marian model's tokens must be identical and its first-step
    log-probs within ``LOGPROB_TOL``; the int8 model's first-step log-probs
    within ``LOGPROB_TOL`` with the card fed the CPU's int8 activations, as
    ``card_vs_cpu`` holds them. The launch counters, zeroed before the card
    calls and read after, must show W8A8, the norm and the gather.
    ``conversion`` is ``start_conversion()``'s process and directory."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    proc, conv = conversion
    stdout, stderr = proc.communicate(timeout=CONVERT_TIMEOUT)
    waited = time.perf_counter() - t0
    if proc.returncode:
        print(stdout[-3000:], stderr[-6000:], file=sys.stderr)
    checks(proc.returncode == 0, f"convert_and_run: the converting subprocess ran to its "
                                 f"end (rc {proc.returncode})")
    if proc.returncode:
        return
    lines = stdout.splitlines()
    modules = [line for line in lines if line.startswith("CONVERT_MODULES")]
    checks(modules == ["CONVERT_MODULES []"] and "JAX_IMPORTED" not in lines,
           f"convert_and_run: the subprocess imported nothing of JAX ({modules})")
    convert_seconds = float(next(line.split()[1] for line in lines
                                 if line.startswith("CONVERT_SECONDS")))
    rng = np.random.default_rng(33)
    sentences = [[f"tok{int(t)}" for t in rng.integers(4, CONVERT["vocab"] - 4,
                                                      int(rng.integers(8, 25)))]
                 for _ in range(CONVERT_SENTENCES)]
    opts = dict(beam_size=BEAM, max_decoding_length=MAX_DEC)
    out, plain, counts = {}, {}, {}
    for name, compute_type in (("marian", "float32"), ("onmt_int8", "int8_float32")):
        path = os.path.join(conv, name)
        cpu = tt.Translator(path, device="cpu", compute_type=compute_type)
        card = tt.Translator(path, device="cuda", compute_type=compute_type)
        recorded = []
        logp_cpu = first_step_logprobs(cpu, sentences, record_quantized(recorded))
        cpu_hyps = [r.hypotheses for r in cpu.translate_batch(sentences, **opts)]
        with chain_off(), watched(logs, plain):
            card_hyps = [r.hypotheses for r in card.translate_batch(sentences, **opts)]
            torch.cuda.synchronize()
            got = dict(tt.launch_counts())
        counts = {k: counts.get(k, 0) + got.get(k, 0) for k in set(counts) | set(got)}
        same = sum(a == b for a, b in zip(card_hyps, cpu_hyps))
        line = {"compute_type": compute_type, "hypotheses_identical":
                f"{same}/{len(sentences)}", "launches": got}
        if recorded:
            replay = ReplayQuantized(recorded)
            diff = (first_step_logprobs(card, sentences, replay) - logp_cpu).abs().max().item()
            checks(replay.calls == len(recorded) > 0 and diff <= LOGPROB_TOL,
                   f"convert_and_run {name}: first-step log-probs fed the CPU's int8 "
                   f"activations within {LOGPROB_TOL} (got {diff}; {replay.calls} of "
                   f"{len(recorded)} linears)")
            line.update(fed_cpu_int8_logprob_max_abs_diff=diff, int8_linears=len(recorded),
                        int8_max_step=replay.max_step)
        else:
            diff = (first_step_logprobs(card, sentences) - logp_cpu).abs().max().item()
            checks(diff <= LOGPROB_TOL and same == len(sentences),
                   f"convert_and_run {name}: tokens identical to the CPU's ({same} of "
                   f"{len(sentences)}), first-step log-probs within {LOGPROB_TOL} (got "
                   f"{diff})")
            line["first_step_logprob_max_abs_diff"] = diff
        out[name] = line
        del cpu, card
        free_card()
    check_path("convert_and_run", counts, ("matmul_w8a8", "fused_norm", "gather_rows_fused"),
               plain, checks)
    emit({"phase": "convert_and_run", "config": CONVERT, "sentences": len(sentences),
          "beam": BEAM, "max_decoding_length": MAX_DEC, "chain_mask": False,
          "converted": {"onmt_py": "cli.convert.opennmt_py_main --quantization int8",
                        "marian": "cli.convert.marian_main"},
          "tolerance": LOGPROB_TOL, "convert_subprocess_seconds": convert_seconds,
          "waited_for_the_subprocess_seconds": waited,
          "seconds": time.perf_counter() - t0, **out})


# ---------------------------------------------------------------------------
# The architecture features at four published families' widths.
# ---------------------------------------------------------------------------

def _family_file(spec_name, revision, config, attrs, norms, jobs, tied=()):
    """A new in-memory ModelFile: ``attrs`` {name: (value, dtype)}, ``norms``
    {scope: (width, with_beta)} (gamma ones, beta zeros), the int8 payloads
    of ``jobs`` (scope, rows, cols, seed) drawn from their seeds, and
    ``tied`` (name, of) pairs sharing a drawn array."""
    import numpy as np
    from ctranslate2_tpu_torch.formats.model_file import ModelFile, make_variable

    mf = ModelFile(spec_name=spec_name, spec_revision=revision, binary_version=6)
    mf.config = {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>", **config}
    for name, (value, dtype) in attrs.items():
        mf.variables[name] = make_variable(name, value, dtype)
    for scope, (width, beta) in norms.items():
        mf.variables[f"{scope}/gamma"] = make_variable(f"{scope}/gamma",
                                                       np.ones(width, np.float32))
        if beta:
            mf.variables[f"{scope}/beta"] = make_variable(f"{scope}/beta",
                                                          np.zeros(width, np.float32))
    _draw_into(mf, jobs, _int8_payload)
    for name, of in tied:
        for suffix in ("weight", "weight_scale"):
            mf.variables[f"{name}/{suffix}"] = make_variable(
                f"{name}/{suffix}", mf.variables[f"{of}/{suffix}"].array)
    return mf


def build_gemma2_modelfile(layers, cfg=GEMMA2_9B):
    """google/gemma-2-9b as the JAX converter writes it (``load_gemma``):
    sandwich norms with the plus-one gamma baked in, a window of 4,096 on
    the even layers, 256^-0.5 queries scale, embeddings scaled by
    sqrt(3,584), final softcap 30, tied projection; int8 payloads."""
    d, h, hkv, hd = cfg["d_model"], cfg["heads"], cfg["heads_kv"], cfg["head_dim"]
    sc = "decoder"
    attrs = {f"{sc}/num_heads": (h, "int16"), f"{sc}/pre_norm": (1, "int8"),
             f"{sc}/activation": (1, "int8"),  # gelu_tanh
             f"{sc}/scale_embeddings": (d ** 0.5, "float32"),
             f"{sc}/final_logit_softcapping": (cfg["final_softcap"], "float32")}
    norms = {f"{sc}/layer_norm": (d, False)}
    jobs = [(f"{sc}/embeddings", cfg["vocab"], d, 0)]
    for i in range(layers):
        ls, asc = f"{sc}/layer_{i}", f"{sc}/layer_{i}/self_attention"
        for name in ("input_layer_norm", "post_attention_layer_norm",
                     "pre_feedforward_layer_norm", "post_feedforward_layer_norm"):
            norms[f"{ls}/{name}"] = (d, False)
        if i % 2 == 0:
            attrs[f"{asc}/sliding_window"] = (cfg["window"], "int32")
        attrs.update({f"{asc}/num_heads_kv": (hkv, "int32"),
                      f"{asc}/head_dim": (hd, "int32"),
                      f"{asc}/rotary_dim": (0, "int32"),
                      f"{asc}/rotary_interleave": (0, "int8"),
                      f"{asc}/rotary_base": (cfg["rotary_base"], "float32"),
                      f"{asc}/queries_scale": (cfg["query_pre_attn_scalar"] ** -0.5,
                                               "float32")})
        jobs += [(f"{asc}/linear_0", (h + 2 * hkv) * hd, d, 10 + i),
                 (f"{asc}/linear_1", d, h * hd, 1000 + i),
                 (f"{ls}/ffn/linear_0", cfg["d_ff"], d, 2000 + i),
                 (f"{ls}/ffn/linear_0_noact", cfg["d_ff"], d, 3000 + i),
                 (f"{ls}/ffn/linear_1", d, cfg["d_ff"], 4000 + i)]
    return _family_file("TransformerDecoderSpec", 8, {"layer_norm_epsilon": cfg["eps"]},
                        attrs, norms, jobs, tied=[(f"{sc}/projection", f"{sc}/embeddings")])


def build_mpt_modelfile(layers, cfg=MPT_7B):
    """mosaicml/mpt-7b as the JAX converter writes it (``load_mpt``): ALiBi
    (positive positions, no scale), LayerNorms with a zero beta, no biases,
    tied projection; int8 payloads."""
    d, sc = cfg["d_model"], "decoder"
    attrs = {f"{sc}/num_heads": (cfg["heads"], "int16"), f"{sc}/pre_norm": (1, "int8"),
             f"{sc}/activation": (3, "int8"),  # gelu
             f"{sc}/scale_embeddings": (0, "int8"), f"{sc}/alibi": (1, "int8")}
    norms = {f"{sc}/layer_norm": (d, True)}
    jobs = [(f"{sc}/embeddings", cfg["vocab"], d, 0)]
    for i in range(layers):
        ls, asc = f"{sc}/layer_{i}", f"{sc}/layer_{i}/self_attention"
        norms[f"{asc}/layer_norm"] = (d, True)
        norms[f"{ls}/ffn/layer_norm"] = (d, True)
        jobs += [(f"{asc}/linear_0", 3 * d, d, 10 + i),
                 (f"{asc}/linear_1", d, d, 1000 + i),
                 (f"{ls}/ffn/linear_0", cfg["d_ff"], d, 2000 + i),
                 (f"{ls}/ffn/linear_1", d, cfg["d_ff"], 4000 + i)]
    return _family_file("TransformerDecoderSpec", 8, {"layer_norm_epsilon": cfg["eps"]},
                        attrs, norms, jobs, tied=[(f"{sc}/projection", f"{sc}/embeddings")])


def build_falcon_modelfile(layers, cfg=FALCON_7B):
    """tiiuae/falcon-7b as the JAX converter writes it (``load_falcon``): 71
    query heads on one KV head (``multi_query``), rotary, one shared
    LayerNorm a layer (parallel residual), no biases, tied projection; int8
    payloads."""
    d, h, sc = cfg["d_model"], cfg["heads"], "decoder"
    hd = d // h
    attrs = {f"{sc}/num_heads": (h, "int16"), f"{sc}/pre_norm": (1, "int8"),
             f"{sc}/activation": (3, "int8"),  # gelu
             f"{sc}/scale_embeddings": (0, "int8")}
    norms = {f"{sc}/layer_norm": (d, True)}
    jobs = [(f"{sc}/embeddings", cfg["vocab"], d, 0)]
    for i in range(layers):
        ls, asc = f"{sc}/layer_{i}", f"{sc}/layer_{i}/self_attention"
        norms[f"{ls}/shared_layer_norm"] = (d, True)
        attrs.update({f"{asc}/multi_query": (1, "int8"),
                      f"{asc}/rotary_dim": (0, "int32"),
                      f"{asc}/rotary_interleave": (0, "int8"),
                      f"{asc}/rotary_base": (cfg["rotary_base"], "float32")})
        jobs += [(f"{asc}/linear_0", (h + 2) * hd, d, 10 + i),
                 (f"{asc}/linear_1", d, d, 1000 + i),
                 (f"{ls}/ffn/linear_0", cfg["d_ff"], d, 2000 + i),
                 (f"{ls}/ffn/linear_1", d, cfg["d_ff"], 4000 + i)]
    return _family_file("TransformerDecoderSpec", 8, {"layer_norm_epsilon": cfg["eps"]},
                        attrs, norms, jobs, tied=[(f"{sc}/projection", f"{sc}/embeddings")])


def build_flan_t5_modelfile(layers, cfg=FLAN_T5_LARGE):
    """google/flan-t5-large as the JAX converter writes it (``load_t5``):
    RMS norms, queries scale 1, the relative-attention bucket table on
    every self-attention (layer 0's, shared down the stack), gated GELU
    (tanh), an untied projection; int8 payloads."""
    import numpy as np

    d, h, hd = cfg["d_model"], cfg["heads"], cfg["head_dim"]
    inner = h * hd
    attrs = {"encoder/embeddings_merge": (0, "int8")}
    norms = {}
    jobs = [("encoder/embeddings_0", cfg["vocab"], d, 0), ("decoder/projection", cfg["vocab"], d, 1)]
    table = (np.random.default_rng(7).standard_normal((cfg["buckets"], h)) * 0.5) \
        .astype(np.float32)
    for side in ("encoder", "decoder"):
        attrs.update({f"{side}/num_heads": (h, "int16"), f"{side}/pre_norm": (1, "int8"),
                      f"{side}/activation": (1, "int8"),  # gelu_tanh
                      f"{side}/scale_embeddings": (0, "int8")})
        norms[f"{side}/layer_norm"] = (d, False)
        for i in range(layers):
            ls = f"{side}/layer_{i}"
            asc = f"{ls}/self_attention"
            norms[f"{asc}/layer_norm"] = (d, False)
            norms[f"{ls}/ffn/layer_norm"] = (d, False)
            attrs.update({f"{asc}/queries_scale": (1.0, "float32"),
                          f"{asc}/relative_attention_bias": (table, None),
                          f"{asc}/relative_attention_max_distance":
                              (cfg["max_distance"], "int32")})
            seed = (0 if side == "encoder" else 100000) + i
            jobs += [(f"{asc}/linear_0", 3 * inner, d, 10 + seed),
                     (f"{asc}/linear_1", d, inner, 1000 + seed),
                     (f"{ls}/ffn/linear_0", cfg["d_ff"], d, 2000 + seed),
                     (f"{ls}/ffn/linear_0_noact", cfg["d_ff"], d, 3000 + seed),
                     (f"{ls}/ffn/linear_1", d, cfg["d_ff"], 4000 + seed)]
            if side == "decoder":
                csc = f"{ls}/attention"
                norms[f"{csc}/layer_norm"] = (d, False)
                attrs[f"{csc}/queries_scale"] = (1.0, "float32")
                jobs += [(f"{csc}/linear_0", inner, d, 5000 + seed),
                         (f"{csc}/linear_1", 2 * inner, d, 6000 + seed),
                         (f"{csc}/linear_2", d, inner, 7000 + seed)]
    mf = _family_file("TransformerSpec", 7,
                      {"layer_norm_epsilon": cfg["eps"], "add_source_bos": False,
                       "add_source_eos": False, "decoder_start_token": "<s>"},
                      attrs, norms, jobs, tied=[("decoder/embeddings", "encoder/embeddings_0")])
    return mf


def family_vocab(size):
    from ctranslate2_tpu_torch.formats.vocabulary import Vocabulary, VocabularyInfo

    return Vocabulary(["<unk>", "<s>", "</s>"] + [f"t{i}" for i in range(size - 3)],
                      VocabularyInfo(unk_token="<unk>", bos_token="<s>", eos_token="</s>"))


def family_prompts(vocab_size, rows, length, seed, prefix="t"):
    """``rows`` prompts of ``length`` tokens of ``family_vocab`` (``prefix``
    "tok": of the builder's vocabulary)."""
    import numpy as np

    r = np.random.default_rng(3000 + seed)
    return [[f"{prefix}{int(t)}" for t in r.integers(10, vocab_size - 13, length)]
            for _ in range(rows)]


def arch_call(label, tt, call, kernels, logs, checks, prefill=None):
    """One watched call: the launch counters zeroed just before and read just
    after, the kernels' call shapes logged, their plain versions' calls on
    the card counted; returns (result, seconds, counts, peak bytes)."""
    import torch

    plain = {}
    with watched(logs, plain):
        out, seconds = synced_seconds(call)
        counts = tt.launch_counts()
        peak = torch.cuda.max_memory_allocated()
    check_path(label, counts, kernels, plain, checks)
    return out, seconds, counts, peak


def timed_prefills(gen):
    """A ``patched`` wrapper for ``Generator._prefill``: the seconds of each
    prefill (synced on either side) into the returned list."""
    import torch

    seconds = []

    def wrap(orig):
        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - start)
            return out
        return wrapped
    return seconds, wrap


def generate_watched(label, tt, gen, prompts, new_tokens, kernels, logs, checks, **kw):
    """``generate_batch`` with exactly ``new_tokens`` new tokens a prompt,
    watched (``arch_call``), with its prefill timed apart; returns its
    numbers as a dict and the results."""
    from ctranslate2_tpu_torch.models import transformer as T

    seconds_list, wrap = timed_prefills(gen)
    chunks = []

    def chunk_log(orig):
        def wrapped(arch, params, consts, ids, pos, *args, **kwargs):
            if ids.shape[-1] > 1:
                chunks.append((pos, ids.shape[-1]))
            return orig(arch, params, consts, ids, pos, *args, **kwargs)
        return wrapped

    # With the prompt in the result, the loop feeds it token by token and
    # ``max_length`` counts it (the reference's rule).
    with_prompt = kw.get("include_prompt_in_result", False)
    steps = new_tokens + (len(prompts[0]) - 1 if with_prompt else 0)
    opts = dict(include_prompt_in_result=False, beam_size=1, min_length=steps,
                max_length=steps, return_scores=True)
    opts.update(kw)
    with patched(gen, "_prefill", wrap), patched(T, "decoder_forward", chunk_log):
        results, seconds, counts, peak = arch_call(
            label, tt, lambda: gen.generate_batch(prompts, **opts), kernels, logs, checks)
    prefill = sum(seconds_list)
    hyps = [r.sequences_ids[0] for r in results]
    checks(all(len(h) == new_tokens + (len(prompts[0]) if with_prompt else 0) for h in hyps)
           and all(math.isfinite(r.scores[0]) for r in results),
           f"{label}: every hypothesis has {new_tokens} new tokens and a finite score")
    tokens = len(prompts) * new_tokens
    return results, {
        "seconds": seconds, "prefill_ms": prefill * 1e3, "prefill_chunks": chunks,
        "decode_ms_per_step": (seconds - prefill) / steps * 1e3,
        "new_tokens_per_s": tokens / seconds, "peak_memory_bytes": peak,
        "launches": counts}


def gemma2_phase(tt, checks, logs):
    """Gemma-2-9B: 2 prompts of 8,257 tokens, int8 KV, greedy, 32 new
    tokens, with the ring (prefill chunks 4,096 / 4,096 / 64 split at the
    ring block; 8,192-slot rings on the windowed layers, which wrap past
    position 8,192; the global layers' linear caches take the decode
    kernel), then ``CT2TPU_WINDOW_RING=0`` (one fresh prefill through flash
    with the window, the decode kernel with the window on linear caches)."""
    from ctranslate2_tpu_torch.models import transformer as T

    cfg = arch_depth(GEMMA2_9B)
    t0 = time.perf_counter()
    mf = build_gemma2_modelfile(cfg["layers"])
    build_s = time.perf_counter() - t0
    vocab = family_vocab(cfg["vocab"])
    layers = cfg["layers"]
    prompts = family_prompts(cfg["vocab"], 2, GEMMA2_PROMPT, 0)
    out = {}
    with environ(CT2TPU_KV_CACHE="int8"):
        t0 = time.perf_counter()
        gen = make_generator(tt, mf, vocab, compute_type="int8")
        load_s = time.perf_counter() - t0
        del mf
        kernels = ("matmul_w8a8", "flash_attention", "decode_attention_int8", "fused_norm")
        for ring in ("1", "0"):
            with environ(CT2TPU_WINDOW_RING=ring):
                results, nums = generate_watched(
                    f"gemma2 ring={ring}", tt, gen, prompts, GEMMA2_NEW, kernels,
                    logs.setdefault(f"gemma2_ring{ring}", {}), checks)
                out["ring_on" if ring == "1" else "ring_off"] = nums
                out.setdefault("tokens", []).append([r.sequences_ids[0] for r in results])
        rb = T.ring_block(gen.model.arch)
        with environ(CT2TPU_WINDOW_RING="1"):
            rb = T.ring_block(gen.model.arch)
    on, off = out["ring_on"], out["ring_off"]
    windowed = sum(1 for l in gen.model.arch.decoder.layers if l.self_attention.sliding_window)
    want = [(0, 4096), (4096, 4096), (8192, GEMMA2_PROMPT - 1 - 8192)]
    checks(rb == cfg["window"] and on["prefill_chunks"] == want
           and off["prefill_chunks"] == [(0, GEMMA2_PROMPT - 1)],
           f"gemma2: ring block {rb}, prefill chunks (position, length) "
           f"{on['prefill_chunks']} (ring) and {off['prefill_chunks']} (no ring)")
    checks(on["launches"]["flash_attention"] == layers
           and on["launches"]["decode_attention_int8"] == (layers - windowed) * GEMMA2_NEW,
           "gemma2 ring: flash on every layer's first chunk, the decode kernel on the "
           f"global layers only ({on['launches']})")
    checks(off["launches"]["flash_attention"] == layers
           and off["launches"]["decode_attention_int8"] == layers * GEMMA2_NEW,
           f"gemma2 no ring: flash and the decode kernel on every layer ({off['launches']})")
    same = sum(a[:GEMMA2_RING_SAME] == b[:GEMMA2_RING_SAME]
               for a, b in zip(*out.pop("tokens")))
    checks(same == len(prompts),
           f"gemma2: ring on and off give the same first {GEMMA2_RING_SAME} tokens "
           f"in {same} of {len(prompts)} rows")
    emit({"phase": "architectures_gemma2", "config": cfg, "source": "google/gemma-2-9b",
          "build_seconds": build_s, "load_seconds": load_s, "prompts": 2,
          "prompt_tokens": GEMMA2_PROMPT, "new_tokens": GEMMA2_NEW, "kv_cache": "int8",
          "ring_block": rb, "windowed_layers": windowed,
          "ring_on_vs_off_rows_with_same_first_tokens": same,
          "first_tokens_compared": GEMMA2_RING_SAME, **out})
    del gen
    free_card()


def mpt_phase(tt, checks, logs):
    """MPT-7B: 4 prompts of 2,049 tokens, int8 KV, greedy, 64 new tokens
    (the prefill through flash with the ALiBi slopes; each decode step the
    plain attention over the dequantized cache with the ALiBi bias, as in
    the JAX package, which declines its decode kernel for ALiBi); then beam
    2 with the float16 KV cache on 2 prompts of ``MPT_BEAM_PROMPT`` tokens,
    16 new tokens, the prompt in the result: the loop makes its own cache
    and feeds the prompt token by token, so every step runs chain-mask
    attention with ALiBi (a prefilled cache takes the gather reorder
    instead, and a prompt of 2,049 fed token by token would take minutes)."""
    cfg = arch_depth(MPT_7B)
    t0 = time.perf_counter()
    mf = build_mpt_modelfile(cfg["layers"])
    build_s = time.perf_counter() - t0
    vocab = family_vocab(cfg["vocab"])
    t0 = time.perf_counter()
    gen = make_generator(tt, mf, vocab, compute_type="int8")
    load_s = time.perf_counter() - t0
    del mf
    with environ(CT2TPU_KV_CACHE="int8"):
        _, greedy = generate_watched(
            "mpt greedy", tt, gen, family_prompts(cfg["vocab"], GEN_BATCH, GEN_PROMPT, 1),
            GEN_NEW, ("matmul_w8a8", "flash_attention", "fused_norm"),
            logs.setdefault("mpt_greedy", {}), checks)
    checks(greedy["launches"]["decode_attention_int8"] == 0
           and greedy["launches"]["flash_attention"] == cfg["layers"],
           f"mpt greedy: flash with slopes a layer, no decode kernel ({greedy['launches']})")
    chain_calls = []
    import ctranslate2_tpu_torch.ops.attention as A

    def count_chain(orig):
        def wrapped(*args, **kwargs):
            chain_calls.append(kwargs.get("alibi_bias") is not None)
            return orig(*args, **kwargs)
        return wrapped

    with patched(A, "beam_chain_attention", count_chain):
        _, beam = generate_watched(
            "mpt beam", tt, gen, family_prompts(cfg["vocab"], 2, MPT_BEAM_PROMPT, 2),
            MPT_BEAM_NEW, ("matmul_w8a8", "fused_norm"), logs.setdefault("mpt_beam", {}),
            checks, beam_size=2, include_prompt_in_result=True)
    steps = MPT_BEAM_PROMPT - 1 + MPT_BEAM_NEW
    checks(len(chain_calls) == steps * cfg["layers"] and all(chain_calls)
           and beam["launches"]["gather_rows_fused"] == 0,
           f"mpt beam: chain-mask attention with ALiBi on every layer and step "
           f"({len(chain_calls)} calls), no gather reorder")
    emit({"phase": "architectures_mpt", "config": cfg, "source": "mosaicml/mpt-7b",
          "build_seconds": build_s, "load_seconds": load_s, "compute_type": gen.compute_type,
          "greedy": dict(greedy, prompts=GEN_BATCH, prompt_tokens=GEN_PROMPT,
                         new_tokens=GEN_NEW, kv_cache="int8"),
          "beam": dict(beam, prompts=2, prompt_tokens=MPT_BEAM_PROMPT,
                       new_tokens=MPT_BEAM_NEW, beam_size=2, kv_cache="float16",
                       chain_attention_calls=len(chain_calls))})
    del gen
    free_card()


def falcon_phase(tt, checks, logs):
    """Falcon-7B: 4 prompts of 2,049 tokens, int8 KV, greedy, 64 new tokens:
    the decode kernel at 71 query heads on one KV head, W8A8 at K 4,544."""
    cfg = arch_depth(FALCON_7B)
    t0 = time.perf_counter()
    mf = build_falcon_modelfile(cfg["layers"])
    build_s = time.perf_counter() - t0
    vocab = family_vocab(cfg["vocab"])
    t0 = time.perf_counter()
    gen = make_generator(tt, mf, vocab, compute_type="int8")
    load_s = time.perf_counter() - t0
    del mf
    with environ(CT2TPU_KV_CACHE="int8"):
        _, nums = generate_watched(
            "falcon", tt, gen, family_prompts(cfg["vocab"], GEN_BATCH, GEN_PROMPT, 3),
            GEN_NEW, ("matmul_w8a8", "flash_attention", "decode_attention_int8",
                      "fused_norm"), logs.setdefault("falcon", {}), checks)
    layers = cfg["layers"]
    checks(nums["launches"]["decode_attention_int8"] == layers * GEN_NEW
           and nums["launches"]["fused_norm"] == (layers + 1) * (1 + GEN_NEW),
           "falcon: one decode launch a layer and step, one shared norm a layer and the "
           f"output norm a pass ({nums['launches']})")
    emit({"phase": "architectures_falcon", "config": cfg, "source": "tiiuae/falcon-7b",
          "build_seconds": build_s, "load_seconds": load_s, "compute_type": gen.compute_type,
          "prompts": GEN_BATCH, "prompt_tokens": GEN_PROMPT, "new_tokens": GEN_NEW,
          "kv_cache": "int8", **nums})
    del gen
    free_card()


def flan_t5_phase(tt, checks, logs):
    """Flan-T5-large: ``Translator(..., flash_attention=True).translate_batch``
    on 16 sources of 1,024 tokens, beam 2, exactly 32 target tokens: the
    encoder through flash (non-causal, the bucket table, per-row lengths),
    the decoder's self-attention with the causal T5 bias on the plain path,
    the beams reordered by the gather kernel."""
    import torch

    cfg = arch_depth(FLAN_T5_LARGE)
    t0 = time.perf_counter()
    mf = build_flan_t5_modelfile(cfg["layers"])
    build_s = time.perf_counter() - t0
    vocab = family_vocab(cfg["vocab"])
    t0 = time.perf_counter()
    tr = tt.Translator(mf, compute_type="int8", flash_attention=True)
    tr.model.source_vocabularies = [vocab]
    tr.model.target_vocabulary = vocab
    load_s = time.perf_counter() - t0
    del mf
    sources = family_prompts(cfg["vocab"], T5_SOURCES, T5_SOURCE_TOKENS, 4)
    opts = dict(beam_size=2, max_decoding_length=T5_TARGET_TOKENS,
                min_decoding_length=T5_TARGET_TOKENS, return_scores=True,
                max_input_length=T5_SOURCE_TOKENS)
    results, seconds, counts, peak = arch_call(
        "flan_t5", tt, lambda: tr.translate_batch(sources, **opts),
        ("matmul_w8a8", "flash_attention", "gather_rows_fused", "fused_norm"),
        logs.setdefault("flan_t5", {}), checks)
    # The encoder alone, for the split of the call's time.
    from ctranslate2_tpu_torch.models import transformer as T

    m = tr.model
    ids = torch.tensor([[vocab.to_id(t) for t in s] for s in sources], device=m.device)
    lengths = torch.full((len(sources),), T5_SOURCE_TOKENS, device=m.device)
    _, enc_seconds, enc_counts, _ = arch_call(
        "flan_t5 encoder", tt, lambda: T.encoder_forward(
            m.arch, m.params, m.consts, ids, lengths,
            quantize_acts=m.policy.quantize_activations, out_dtype=m.out_dtype),
        ("flash_attention",), {}, checks)
    checks(all(len(r.hypotheses[0]) == T5_TARGET_TOKENS and math.isfinite(r.scores[0])
               for r in results),
           f"flan_t5: {T5_TARGET_TOKENS} target tokens and a finite score a source")
    checks(counts["flash_attention"] == cfg["layers"],
           f"flan_t5: one flash launch an encoder layer ({counts['flash_attention']})")
    tokens = T5_SOURCES * T5_TARGET_TOKENS
    emit({"phase": "architectures_flan_t5", "config": cfg, "source": "google/flan-t5-large",
          "build_seconds": build_s, "load_seconds": load_s, "compute_type": tr.compute_type,
          "sources": T5_SOURCES, "source_tokens": T5_SOURCE_TOKENS, "beam_size": 2,
          "target_tokens": T5_TARGET_TOKENS, "seconds": seconds,
          "target_tokens_per_s": tokens / seconds, "encoder_seconds": enc_seconds,
          "decode_ms_per_step": (seconds - enc_seconds) / T5_TARGET_TOKENS * 1e3,
          "peak_memory_bytes": peak, "launches": counts,
          "launches_encoder": enc_counts})
    del tr
    free_card()


def _ab_file_edits(path, edits):
    """Writes ``edits`` {name: array} into the model directory at ``path``
    (an attribute the builder does not take, or Shaw tables)."""
    from ctranslate2_tpu_torch.formats.model_file import load_model_file, make_variable

    mf = load_model_file(path)
    for name, value in edits(mf).items():
        mf.variables[name] = make_variable(name, value)
    mf.save(path)
    return path


def _shaw_tables(mf):
    """Shaw keys and values (max position 8) in every self-attention."""
    import numpy as np

    rng = np.random.default_rng(11)
    out = {}
    for name in list(mf.variables):
        if name.endswith("/self_attention/linear_1/weight"):
            scope = name[:-len("/linear_1/weight")]
            side = scope.split("/")[0]
            hd = mf.variables[name].shape[0] // int(mf.variables[f"{side}/num_heads"].array)
            for table in ("relative_position_keys", "relative_position_values"):
                out[f"{scope}/{table}"] = (rng.standard_normal((17, hd)) * 0.05) \
                    .astype(np.float32)
    return out


def architectures_card_vs_cpu(tt, work, checks):
    """At ``AB_LAYERS`` layers in float32, every architecture feature on the
    card against the port on the CPU, both with ``flash_attention=True``:
    the first decode step's log-probs after a prefill within
    ``LOGPROB_TOL``, and the same greedy tokens (``ARCH_AB_NEW``). Builder
    models at ``ARCH_AB`` widths (ALiBi both ways and with ``scale_alibi``,
    Shaw positions, the T5 bias, a uniform window, Gemma-style hybrid
    windows, both parallel-residual forms; seq2seq: Shaw, merged
    attention), the Gemma-2 and Flan-T5 layouts at small widths (sandwich
    norms and windows; the T5 bias through the encoder's flash table), and
    the ring on against the ring off on the card (prompts past 2 x Wr)."""
    import numpy as np
    import torch
    from ctranslate2_tpu_torch.converters import builder as tb

    t0 = time.perf_counter()
    kw = dict(ARCH_AB, num_layers=AB_LAYERS)
    decoders = {
        "alibi": dict(alibi=True),
        "alibi_negative": dict(alibi=True, alibi_positive=False),
        "alibi_scaled": dict(alibi=True),
        "shaw": dict(rel_position_max=8),
        "t5_bias": dict(rel_bias_buckets=32, rel_bias_max_distance=128),
        "window": dict(sliding_window=ARCH_AB_WINDOW, rotary_dim=0),
        "hybrid_windows": dict(sliding_window=ARCH_AB_WINDOW, rotary_dim=0,
                               sliding_window_pattern=2),
        "parallel_shared_norm": dict(parallel_residual=True, shared_layer_norm=True,
                                     rotary_dim=0),
        "parallel_two_norms": dict(parallel_residual=True, rotary_dim=0),
    }
    rows = {}

    def decoder_pair(name, source):
        card = tt.Generator(source, compute_type="float32", flash_attention=True)
        cpu = tt.Generator(source, device="cpu", compute_type="float32",
                           flash_attention=True)
        for g in (card, cpu):
            if not isinstance(source, str):
                g.model.target_vocabulary = family_vocab(ARCH_AB["vocab_size"])
        return card, cpu

    def compare_generators(name, source, length):
        """With the float KV cache within ``LOGPROB_TOL``, and with the int8
        one (the first step reads a linear cache: windowed layers take the
        decode kernel with the window, ALiBi and relative positions the
        dequantized cache; greedy search then runs ring layers on their
        dequantized rings) within ``INT8_KV_LOGPROB_TOL``."""
        card, cpu = decoder_pair(name, source)
        prompts = family_prompts(ARCH_AB["vocab_size"], 2, length, 5,
                                 "tok" if isinstance(source, str) else "t")
        for kv, tol, row in (("", LOGPROB_TOL, name),
                             ("int8", INT8_KV_LOGPROB_TOL, f"{name}_int8_kv")):
            with environ(CT2TPU_KV_CACHE=kv):
                tt.reset_launches()
                lp_card = generator_first_step_logprobs(card, prompts)
                counts = tt.launch_counts()
                lp_cpu = generator_first_step_logprobs(cpu, prompts)
                opts = dict(max_length=ARCH_AB_NEW, include_prompt_in_result=False)
                same = [a.sequences_ids == b.sequences_ids for a, b in zip(
                    card.generate_batch(prompts, **opts),
                    cpu.generate_batch(prompts, **opts))]
            diff = (lp_card - lp_cpu).abs().max().item()
            # Shaw keys and values decline the flash kernel, and so does the
            # decoder's T5 bias (the JAX package gives the kernel its table in
            # the encoder only); every other prefill takes it.
            flash = name not in ("shaw", "t5_bias")
            checks(diff <= tol and all(same) and (counts["flash_attention"] > 0) == flash,
                   f"architectures card vs CPU, {row}: first-step log-probs within "
                   f"{tol} (got {diff}), same tokens ({same}), flash on the card "
                   f"{flash} ({counts['flash_attention']})")
            rows[row] = {"first_step_logprob_max_abs_diff": diff, "tolerance": tol,
                         "same_tokens": all(same), "prompt_tokens": length,
                         "launches_first_step": counts}
        return card

    for name, extra in decoders.items():
        path = tb.build_decoder_only_model(os.path.join(work, f"ab_{name}"),
                                           **{**kw, **extra})
        if name == "alibi_scaled":
            _ab_file_edits(path, lambda mf: {"decoder/scale_alibi": np.int8(1)})
        length = ARCH_AB_LONG if "window" in name else CPU_PROMPT
        card = compare_generators(name, path, length)
        if name == "hybrid_windows":
            # The ring on against the ring off, on the card: wraps past 2 x Wr.
            # With the int8 KV cache the ring is dequantized, the linear
            # cache read by the decode kernel with the window.
            prompts = family_prompts(ARCH_AB["vocab_size"], 2, ARCH_AB_LONG, 6, "tok")
            opts = dict(max_length=ARCH_AB_NEW, include_prompt_in_result=False,
                        return_scores=True)
            for kv, tol, row in (("", LOGPROB_TOL, "ring_on_vs_off_on_card"),
                                 ("int8", INT8_KV_LOGPROB_TOL,
                                  "ring_on_vs_off_on_card_int8_kv")):
                with environ(CT2TPU_KV_CACHE=kv):
                    with environ(CT2TPU_WINDOW_RING="1"):
                        on = card.generate_batch(prompts, **opts)
                    with environ(CT2TPU_WINDOW_RING="0"):
                        tt.reset_launches()
                        off = card.generate_batch(prompts, **opts)
                        counts = tt.launch_counts()
                diff = max(abs(a.scores[0] - b.scores[0]) for a, b in zip(on, off))
                same = all(a.sequences_ids == b.sequences_ids for a, b in zip(on, off))
                kernel = kv != "int8" or counts["decode_attention_int8"] > 0
                checks(same and diff <= tol and kernel,
                       f"architectures on the card, {row}: same tokens ({same}), "
                       f"scores within {tol} (got {diff}), the decode kernel on the "
                       f"linear int8 cache ({counts['decode_attention_int8']})")
                rows[row] = {"score_max_abs_diff": diff, "tolerance": tol,
                             "same_tokens": same, "prompt_tokens": ARCH_AB_LONG,
                             "launches_ring_off": counts}
        del card
    gemma = build_gemma2_modelfile(AB_LAYERS, cfg=GEMMA2_AB)
    compare_generators("sandwich_gemma2_layout", gemma, ARCH_AB_LONG)
    del gemma

    def compare_translators(name, source):
        card = tt.Translator(source, compute_type="float32", flash_attention=True)
        cpu = tt.Translator(source, device="cpu", compute_type="float32",
                            flash_attention=True)
        if not isinstance(source, str):
            for tr in (card, cpu):
                vocab = family_vocab(FLAN_T5_AB["vocab"])
                tr.model.source_vocabularies = [vocab]
                tr.model.target_vocabulary = vocab
            size = FLAN_T5_AB["vocab"]
        else:
            size = ARCH_AB["vocab_size"]
        sources = family_prompts(size, 4, 200, 7,
                                 "tok" if isinstance(source, str) else "t")
        tt.reset_launches()
        lp_card = first_step_logprobs(card, sources)
        counts = tt.launch_counts()
        lp_cpu = first_step_logprobs(cpu, sources)
        opts = dict(beam_size=2, max_decoding_length=ARCH_AB_NEW)
        same = [a.hypotheses == b.hypotheses for a, b in zip(
            card.translate_batch(sources, **opts), cpu.translate_batch(sources, **opts))]
        diff = (lp_card - lp_cpu).abs().max().item()
        checks(diff <= LOGPROB_TOL and all(same),
               f"architectures card vs CPU, {name}: first-step log-probs within "
               f"{LOGPROB_TOL} (got {diff}), same beam hypotheses ({same})")
        rows[name] = {"first_step_logprob_max_abs_diff": diff, "same_tokens": all(same),
                      "launches_first_step": counts}
        return counts

    s2s = dict(vocab_size=ARCH_AB["vocab_size"], num_layers=AB_LAYERS,
               num_heads=ARCH_AB["num_heads"], d_model=ARCH_AB["d_model"],
               d_ff=ARCH_AB["d_ff"])
    path = tb.build_seq2seq_model(os.path.join(work, "ab_shaw_s2s"), **s2s)
    compare_translators("shaw_seq2seq", _ab_file_edits(path, _shaw_tables))
    path = tb.build_seq2seq_model(os.path.join(work, "ab_merged"), merged_attention=True,
                                  **s2s)
    compare_translators("merged_attention", path)
    t5 = build_flan_t5_modelfile(AB_LAYERS, cfg=FLAN_T5_AB)
    counts = compare_translators("t5_bias_seq2seq", t5)
    checks(counts["flash_attention"] == AB_LAYERS,
           f"architectures card vs CPU, T5: the encoder's flash with the bucket table "
           f"({counts['flash_attention']})")
    emit({"phase": "architectures_card_vs_cpu", "layers": AB_LAYERS, "widths": ARCH_AB,
          "tolerance": LOGPROB_TOL, "int8_kv_tolerance": INT8_KV_LOGPROB_TOL,
          "checks": rows, "seconds": time.perf_counter() - t0})


# The decode kernel's lengths on each architecture path: (the first step's
# cache length, the steps of a call).
ARCH_DECODE_LENGTHS = {"gemma2_ring1": (GEMMA2_PROMPT - 1, GEMMA2_NEW),
                       "gemma2_ring0": (GEMMA2_PROMPT - 1, GEMMA2_NEW),
                       # Whisper: the prompt's first two tokens prefilled,
                       # then up to 224 steps (max_length 448 halved).
                       "whisper": (2, 448 // 2)}


def arch_benches(arch_logs, seen, checks, prefix="architectures_"):
    """Every shape the paths of ``arch_logs`` gave a kernel that no earlier
    path did (``seen``: the earlier paths' logs), held against the kernel's
    plain version and timed in a row of its own (``"summed": false``).
    Returns ``seen`` with their shapes added."""
    done = {name: dict(shapes) for name, shapes in seen.items()}
    for path, plogs in arch_logs.items():
        fresh = new_shapes(plogs, done)
        extra = dict(summed=False, paths=f"{prefix}{path}")
        bench_w8a8(fresh.get("matmul_w8a8", {}), checks, **extra)
        free_card()
        bench_flash(fresh.get("flash_attention", {}), checks, **extra)
        free_card()
        bench_norm(fresh.get("fused_norm", {}), checks, **extra)
        bench_gather(fresh.get("gather_rows_fused", {}), checks, **extra)
        for key, n in fresh.get("decode_attention_int8", {}).items():
            # The run's cache lengths: the path's, held inside the shape's
            # capacity (Whisper's language detection reads a 16-slot cache).
            first, steps = ARCH_DECODE_LENGTHS.get(path, (GEN_PROMPT - 1, GEN_NEW))
            if first + steps > key[2]:
                first, steps = 0, 1
            bench_decode({key: n}, first, steps, checks, **extra)
        free_card()
        for name, shapes in fresh.items():
            done.setdefault(name, {}).update(shapes)
    return done


def architectures_phase(tt, work, checks, logs):
    """The four families at their published widths (``logs[path]`` gets
    each call's kernel shapes)."""
    t0 = time.perf_counter()
    gemma2_phase(tt, checks, logs)
    mpt_phase(tt, checks, logs)
    falcon_phase(tt, checks, logs)
    flan_t5_phase(tt, checks, logs)
    emit({"phase": "architectures", "seconds": time.perf_counter() - t0})


# ---------------------------------------------------------------------------
# The file and streaming helpers, and the speech models.
# ---------------------------------------------------------------------------

FILE_SENTENCES = 4 * BATCH  # four phase-2 batches
FILE_STREAM_NEW = 64  # generate_tokens: new tokens after one 2,049-token prompt
FILE_ITERABLE_NEW = 16
FILE_SAME_SHARE = 0.95  # of lines equal between read windows of 64 and 1,024
# openai/whisper-large-v3 (config.json): 32 + 32 layers, d_model 1,280, 20
# heads, ffn 5,120, 128 mel bins, 1,500 / 448 positions, 51,866 tokens: 50,256
# text tokens, <|endoftext|>, <|startoftranscript|>, 100 languages, 6 special
# tokens and 1,502 timestamps. Its alignment heads are the model's own
# (generation_config.json).
WHISPER_LARGE_V3 = dict(layers=32, d_model=1280, heads=20, d_ff=5120, n_mels=128,
                        source_positions=1500, target_positions=448, text_tokens=50256,
                        languages=100, timestamps=1502,
                        alignment_heads=((7, 0), (10, 17), (12, 18), (13, 12), (16, 1),
                                         (17, 14), (19, 11), (21, 4), (24, 1), (25, 6)))
# The Whisper phase's depth: a quarter of large-v3's 32 + 32 layers at
# its published widths (the run's time limit); the alignment heads of the
# layers kept.
WHISPER_LAYERS = WHISPER_LARGE_V3["layers"] // 4
# facebook/wav2vec2-large-960h-lv60-self (config.json): 7 layer-normed
# feature convolutions of 512 channels, 24 layers, d_model 1,024, 16 heads,
# ffn 4,096, a 128-tap positional convolution in 16 groups, 32 CTC symbols.
WAV2VEC2_LARGE = dict(layers=24, d_model=1024, heads=16, d_ff=4096, conv_dim=512,
                      conv_kernel=(10, 3, 3, 3, 3, 2, 2), conv_stride=(5, 2, 2, 2, 2, 2, 2),
                      pos_taps=128, pos_groups=16, vocab=32, eps=1e-5)
# facebook/w2v-bert-2.0 (config.json): 24 conformer layers, d_model 1,024, 16
# heads, ffn 4,096, 160 input features, a depthwise kernel of 31, relative
# keys 64 left / 8 right; one stride-2 adapter layer and a CTC head as its
# CTC fine-tunes add them (the head's width is not in the base config: 32).
W2V_BERT_2 = dict(layers=24, d_model=1024, heads=16, d_ff=4096, input_dim=160,
                  depthwise=31, left=64, right=8, adapter_layers=1, vocab=32)
SPEECH_BATCH = 4  # Whisper: 4 x 30 s
WHISPER_FRAMES = 3000
WHISPER_MAX_LENGTH = 448
WHISPER_SHORT_LENGTH = 128  # the previous-text and greedy calls: 64 steps
WHISPER_PREV_TOKENS = 32  # the <|startofprev|> prompt, SOT tokens included
WHISPER_ALIGN_TOKENS = 32
W2V_BATCH, W2V_SAMPLES = 8, 320_000  # 8 x 20 s at 16 kHz: 999 frames
W2V_BERT_BATCH, W2V_BERT_FRAMES = 8, 1000
AB_WHISPER_BATCH, AB_WHISPER_MAX_LENGTH = 2, 96
AB_W2V_SAMPLES = 80_000


def _conv_payload(job):
    """An int8 convolution weight of (scope, shape, seed): as ``_int8_payload``,
    one scale an output channel."""
    import numpy as np

    scope, shape, seed = job
    q = np.random.default_rng(seed).integers(-127, 128, shape, dtype=np.int8)
    return scope, {"weight": q,
                   "weight_scale": np.full((shape[0],), 127.0 / 0.05, np.float32)}


def _speech_file(spec_name, revision, config, attrs, norms, jobs, convs, floats,
                 zeroed=()):
    """``_family_file`` with int8 convolution payloads (``convs``: scope,
    shape, seed) and float arrays (``floats``: name, shape, seed, scale),
    which the speech layouts add: biases, position tables, relative keys;
    ``zeroed`` (name, slice) pairs are set to zero."""
    import numpy as np
    from ctranslate2_tpu_torch.formats.model_file import make_variable

    mf = _family_file(spec_name, revision, config, attrs, norms, jobs)
    _draw_into(mf, convs, _conv_payload)
    zero = dict(zeroed)
    for name, shape, seed, scale in floats:
        value = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale
        if name in zero:
            value[zero[name]] = 0.0
        mf.variables[name] = make_variable(name, value)
    return mf


def whisper_vocab(cfg=WHISPER_LARGE_V3):
    """The vocabulary of ``build_whisper_modelfile`` in the reference layout
    (as ``converters/builder.py::build_whisper_model`` lays it out)."""
    vocab = [""] + [f"w{i}" for i in range(cfg["text_tokens"] - 1)]
    vocab += ["<|endoftext|>", "<|startoftranscript|>"]
    vocab += ["<|en|>"] + [f"<|l{i}|>" for i in range(1, cfg["languages"])]
    vocab += ["<|translate|>", "<|transcribe|>", "<|startoflm|>", "<|startofprev|>",
              "<|nospeech|>", "<|notimestamps|>"]
    vocab += [f"<|{i * 0.02:.2f}|>" for i in range(cfg["timestamps"])]
    return vocab


def build_whisper_modelfile(layers, cfg=WHISPER_LARGE_V3):
    """openai/whisper-large-v3 as the JAX converter writes it
    (``load_whisper``), int8: the two convolutions, learned position tables,
    the fused self-QKV, the cross-attention's ``linear_1`` with K's half of
    the bias zero, the projection tied to the embeddings, and the
    suppression, language and alignment-head lists in the config. Returns
    (ModelFile, vocabulary)."""
    from ctranslate2_tpu_torch.formats.model_file import make_variable

    vocab = whisper_vocab(cfg)
    d, ff, V = cfg["d_model"], cfg["d_ff"], len(vocab)
    sot = vocab.index("<|startoftranscript|>")
    attrs = {"encoder/num_heads": (cfg["heads"], "int16"),
             "decoder/num_heads": (cfg["heads"], "int16"),
             "decoder/pre_norm": (1, "int8"), "decoder/activation": (3, "int8")}
    norms = {"encoder/layer_norm": (d, True), "decoder/layer_norm": (d, True)}
    jobs = [("decoder/embeddings", V, d, 0)]
    convs = [("encoder/conv1", (d, cfg["n_mels"], 3), 1), ("encoder/conv2", (d, d, 3), 2)]
    floats = [("encoder/conv1/bias", (d,), 3, 0.02), ("encoder/conv2/bias", (d,), 4, 0.02),
              ("encoder/position_encodings/encodings", (cfg["source_positions"], d), 5, 0.5),
              ("decoder/position_encodings/encodings", (cfg["target_positions"], d), 6, 0.5)]
    zero_k = []
    for side in ("encoder", "decoder"):
        for i in range(layers):
            ls = f"{side}/layer_{i}"
            seed = (0 if side == "encoder" else 100000) + 10 * i
            asc = f"{ls}/self_attention"
            norms.update({f"{asc}/layer_norm": (d, True), f"{ls}/ffn/layer_norm": (d, True)})
            jobs += [(f"{asc}/linear_0", 3 * d, d, 10 + seed), (f"{asc}/linear_1", d, d, 11 + seed),
                     (f"{ls}/ffn/linear_0", ff, d, 12 + seed), (f"{ls}/ffn/linear_1", d, ff, 13 + seed)]
            floats += [(f"{asc}/linear_0/bias", (3 * d,), 20 + seed, 0.02),
                       (f"{asc}/linear_1/bias", (d,), 21 + seed, 0.02),
                       (f"{ls}/ffn/linear_0/bias", (ff,), 22 + seed, 0.02),
                       (f"{ls}/ffn/linear_1/bias", (d,), 23 + seed, 0.02)]
            zero_k.append((f"{asc}/linear_0/bias", slice(d, 2 * d)))
            if side == "decoder":
                csc = f"{ls}/attention"
                norms[f"{csc}/layer_norm"] = (d, True)
                jobs += [(f"{csc}/linear_0", d, d, 14 + seed), (f"{csc}/linear_1", 2 * d, d, 15 + seed),
                         (f"{csc}/linear_2", d, d, 16 + seed)]
                floats += [(f"{csc}/linear_0/bias", (d,), 24 + seed, 0.02),
                           (f"{csc}/linear_1/bias", (2 * d,), 25 + seed, 0.02),
                           (f"{csc}/linear_2/bias", (d,), 26 + seed, 0.02)]
                zero_k.append((f"{csc}/linear_1/bias", slice(0, d)))
    config = {"suppress_ids": [1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60],
              "suppress_ids_begin": [220, vocab.index("<|endoftext|>")],
              "lang_ids": list(range(sot + 1, sot + 1 + cfg["languages"])),
              "alignment_heads": [list(p) for p in cfg["alignment_heads"]
                                  if p[0] < layers] or [[layers - 1, 0]]}
    # Whisper's K projections have no bias: their half of the fused bias is
    # zero. The projection is the embedding.
    mf = _speech_file("WhisperSpec", 3, config, attrs, norms, jobs, convs, floats,
                      zeroed=zero_k)
    for suffix in ("weight", "weight_scale"):
        mf.variables[f"decoder/projection/{suffix}"] = make_variable(
            f"decoder/projection/{suffix}", mf.variables[f"decoder/embeddings/{suffix}"].array)
    return mf, vocab


def save_whisper(mf, vocab, directory):
    """Whisper reads its vocabulary from its directory: the model and
    ``vocabulary.json`` written there."""
    mf.save(directory)
    with open(os.path.join(directory, "vocabulary.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    return directory


def build_wav2vec2_modelfile(layers, cfg=WAV2VEC2_LARGE):
    """facebook/wav2vec2-large-960h-lv60-self as the JAX converter writes it
    (``load_wav2vec2``), int8: the layer-normed feature convolutions, the
    feature projection, the grouped positional convolution, the pre-norm
    stack and the CTC head."""
    d, ff, c = cfg["d_model"], cfg["d_ff"], cfg["conv_dim"]
    sc = "encoder"
    attrs = {f"{sc}/num_heads": (cfg["heads"], "int16")}
    norms = {f"{sc}/fp_layer_norm": (c, True), f"{sc}/layer_norm": (d, True)}
    convs, floats = [], []
    for i, k in enumerate(cfg["conv_kernel"]):
        scope = f"{sc}/feat_layer0" if i == 0 else f"{sc}/feat_layer_{i - 1}"
        convs.append((f"{scope}/conv", (c, 1 if i == 0 else c, k), 50 + i))
        floats.append((f"{scope}/conv/bias", (c,), 60 + i, 0.02))
        norms[f"{scope}/layer_norm"] = (c, True)
    convs.append((f"{sc}/pos_conv_embed/conv", (d, d // cfg["pos_groups"], cfg["pos_taps"]), 70))
    floats += [(f"{sc}/pos_conv_embed/conv/bias", (d,), 71, 0.02),
               (f"{sc}/fp_projection/bias", (d,), 72, 0.02),
               (f"{sc}/lm_head/bias", (cfg["vocab"],), 73, 0.02)]
    jobs = [(f"{sc}/fp_projection", d, c, 74), (f"{sc}/lm_head", cfg["vocab"], d, 75)]
    for i in range(layers):
        ls = f"{sc}/layer_{i}"
        asc = f"{ls}/self_attention"
        norms.update({f"{asc}/layer_norm": (d, True), f"{ls}/ffn/layer_norm": (d, True)})
        jobs += [(f"{asc}/linear_0", 3 * d, d, 100 + 10 * i), (f"{asc}/linear_1", d, d, 101 + 10 * i),
                 (f"{ls}/ffn/linear_0", ff, d, 102 + 10 * i), (f"{ls}/ffn/linear_1", d, ff, 103 + 10 * i)]
        floats += [(f"{asc}/linear_0/bias", (3 * d,), 104 + 10 * i, 0.02),
                   (f"{ls}/ffn/linear_0/bias", (ff,), 105 + 10 * i, 0.02)]
    return _speech_file("Wav2Vec2Spec", 3, {"layer_norm_epsilon": cfg["eps"]}, attrs, norms,
                        jobs, convs, floats)


def build_w2v_bert_modelfile(layers, cfg=W2V_BERT_2):
    """facebook/w2v-bert-2.0 with one adapter layer and a CTC head as the JAX
    converter writes it (``load_wav2vec2bert``), int8: the feature
    projection, the conformer layers (relative keys of 64 left / 8 right,
    the pointwise / depthwise / pointwise convolutions without biases), the
    stride-2 adapter and the head."""
    d, ff, h = cfg["d_model"], cfg["d_ff"], cfg["heads"]
    sc = "encoder"
    attrs, norms, convs, floats = {}, {f"{sc}/fp_layer_norm": (cfg["input_dim"], True)}, [], []
    jobs = [(f"{sc}/fp_projection", d, cfg["input_dim"], 80), (f"{sc}/lm_head", cfg["vocab"], d, 81)]
    floats += [(f"{sc}/fp_projection/bias", (d,), 82, 0.02),
               (f"{sc}/lm_head/bias", (cfg["vocab"],), 83, 0.02)]

    def attention(scope, seed, rel):
        nonlocal jobs, floats
        jobs += [(f"{scope}/linear_0", 3 * d, d, seed), (f"{scope}/linear_1", d, d, seed + 1)]
        floats.append((f"{scope}/linear_0/bias", (3 * d,), seed + 2, 0.02))
        attrs[f"{scope}/num_heads"] = (h, "int16")
        if rel:
            floats.append((f"{scope}/relative_asymmetric_position_keys",
                           (cfg["left"] + cfg["right"] + 1, d // h), seed + 3, 0.5))
            attrs[f"{scope}/relative_left_max_position"] = (cfg["left"], "int32")
            attrs[f"{scope}/relative_right_max_position"] = (cfg["right"], "int32")

    for i in range(layers):
        ls = f"{sc}/encoder_layers_{i}"
        s = 1000 + 20 * i
        for name in ("enc_ffn1", "enc_ffn2"):
            jobs += [(f"{ls}/{name}/linear_0", ff, d, s), (f"{ls}/{name}/linear_1", d, ff, s + 1)]
            s += 2
        attention(f"{ls}/enc_attn", s, True)
        convs += [(f"{ls}/enc_conv_pointwise_conv1", (2 * d, d, 1), s + 4),
                  (f"{ls}/enc_conv_depthwise_conv", (d, 1, cfg["depthwise"]), s + 5),
                  (f"{ls}/enc_conv_pointwise_conv2", (d, d, 1), s + 6)]
        for name in ("enc_ffn1_layer_norm", "enc_attn_layer_norm", "enc_conv_layer_norm",
                     "enc_conv_depthwise_layer_norm", "enc_ffn2_layer_norm",
                     "enc_final_layer_norm"):
            norms[f"{ls}/{name}"] = (d, True)
    for i in range(cfg["adapter_layers"]):
        ls = f"{sc}/adapter_layers_{i}"
        s = 5000 + 20 * i
        for name in ("adpt_residual_conv", "adpt_attn_conv"):
            convs.append((f"{ls}/{name}", (2 * d, d, 3), s))
            floats.append((f"{ls}/{name}/bias", (2 * d,), s + 1, 0.02))
            s += 2
        attention(f"{ls}/adpt_attn_layer", s, False)
        jobs += [(f"{ls}/adpt_ffn/linear_0", ff, d, s + 4), (f"{ls}/adpt_ffn/linear_1", d, ff, s + 5)]
        for name in ("adpt_residual_layer_norm", "adpt_attn_layer_norm", "adpt_ffn_layer_norm"):
            norms[f"{ls}/{name}"] = (d, True)
    return _speech_file("Wav2Vec2BertSpec", 1, {}, attrs, norms, jobs, convs, floats)


def _timed_forwards(T):
    """A ``patched`` wrapper for ``models.transformer.decoder_forward``: the
    synced seconds of every multi-token call (a prefill) and the count of
    single-token calls (decode steps)."""
    import torch

    stats = {"prefill_s": 0.0, "prefills": 0, "steps": 0}

    def wrap(orig):
        def wrapped(arch, params, consts, ids, *args, **kwargs):
            if ids.shape[-1] == 1:
                stats["steps"] += 1
                return orig(arch, params, consts, ids, *args, **kwargs)
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = orig(arch, params, consts, ids, *args, **kwargs)
            torch.cuda.synchronize()
            stats["prefill_s"] += time.perf_counter() - start
            stats["prefills"] += 1
            return out
        return wrapped
    return stats, wrap


def file_helpers_translator(tt, model_dir, batches, work, checks, logs):
    """``Translator.translate_file`` of the four phase-2 batches (256
    sentences) at ``max_batch_size`` 64 against ``translate_batch``'s
    hypotheses, with scores, and with read windows of 64 against the default
    (1,024); ``score_file`` on the pair against ``score_batch``'s means;
    ``translate_iterable`` against the batch calls."""
    tr = tt.Translator(model_dir, compute_type="int8")
    sents = [s for b in batches[:4] for s in b]
    src = os.path.join(work, "file_src.txt")
    with open(src, "w", encoding="utf-8") as f:
        f.write("".join(" ".join(s) + "\n" for s in sents))
    opts = dict(OPTS, max_batch_size=BATCH)
    tr.translate_batch(batches[0], **OPTS)  # warm-up
    ref, batch_s = synced_seconds(lambda: tr.translate_batch(sents, **opts))
    out = {}
    for label, kw in (("plain", {}), ("with_scores", dict(with_scores=True)),
                      ("read_batch_64", dict(read_batch_size=BATCH))):
        path = os.path.join(work, f"file_out_{label}.txt")
        plain = {}
        with watched(logs, plain):
            stats, seconds = synced_seconds(lambda: tr.translate_file(src, path, **opts, **kw))
            counts = tt.launch_counts()
        check_path(f"file_helpers translate_file {label}", counts,
                   ["matmul_w8a8", "fused_norm"], plain, checks)
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        texts = [line.split(" ||| ", 1)[1] if kw.get("with_scores") else line for line in lines]
        same = sum(t == " ".join(r.hypotheses[0]) for t, r in zip(texts, ref))
        need = FILE_SENTENCES if label != "read_batch_64" else FILE_SAME_SHARE * FILE_SENTENCES
        checks(len(lines) == FILE_SENTENCES and same >= need,
               f"file_helpers translate_file {label}: {same} of {len(lines)} lines equal "
               f"to translate_batch's hypotheses (at least {need})")
        if kw.get("with_scores"):
            diff = max(abs(float(line.split(" ||| ")[0]) - r.scores[0])
                       for line, r in zip(lines, ref))
            checks(diff <= 1e-6, f"file_helpers translate_file with_scores: scores "
                                 f"equal to translate_batch's (max abs diff {diff})")
        out[label] = {"seconds": seconds, "target_tokens": stats.num_tokens,
                      "target_tokens_per_s": stats.num_tokens / seconds,
                      "lines_equal_to_batch": same, "launches": counts,
                      "stats_ms": stats.total_time_in_ms}
    tokens = sum(len(r.hypotheses[0]) for r in ref)
    out["translate_batch"] = {"seconds": batch_s, "target_tokens": tokens,
                              "target_tokens_per_s": tokens / batch_s}

    # score_file on (source, its translations) against score_batch.
    tgt = os.path.join(work, "file_out_plain.txt")
    scored = os.path.join(work, "file_scores.txt")
    plain = {}
    with watched(logs, plain):
        _, seconds = synced_seconds(lambda: tr.score_file(src, tgt, scored))
        counts = tt.launch_counts()
    check_path("file_helpers score_file", counts, ["matmul_w8a8", "fused_norm"], plain, checks)
    with open(tgt, encoding="utf-8") as f:
        targets = [line.split() for line in f.read().splitlines()]
    ref_scores = tr.score_batch(sents, targets, max_batch_size=32)
    with open(scored, encoding="utf-8") as f:
        means = [float(line.split(" ||| ")[0]) for line in f.read().splitlines()]
    diff = max(abs(m - r.normalized_score()) for m, r in zip(means, ref_scores))
    checks(len(means) == FILE_SENTENCES and diff <= 1e-6,
           f"file_helpers score_file: means equal to score_batch's to 1e-6 ({diff})")
    out["score_file"] = {"seconds": seconds, "max_abs_diff": diff, "launches": counts}

    # translate_iterable against the batch calls on the same batches.
    plain = {}
    with watched(logs, plain):
        it, seconds = synced_seconds(lambda: list(tr.translate_iterable(
            iter(sents), max_batch_size=BATCH, **OPTS)))
        counts = tt.launch_counts()
    check_path("file_helpers translate_iterable", counts, ["matmul_w8a8", "fused_norm"],
               plain, checks)
    per_batch = [r for b in batches[:4] for r in tr.translate_batch(b, **OPTS)]
    checks([r.hypotheses for r in it] == [r.hypotheses for r in per_batch],
           "file_helpers translate_iterable: the batch calls' hypotheses, in order")
    out["translate_iterable"] = {"seconds": seconds, "launches": counts}
    emit({"phase": "file_helpers_translator", "sentences": FILE_SENTENCES,
          "max_batch_size": BATCH, **out})
    del tr


def file_helpers_generator(tt, gen, vocab, checks, logs):
    """On the int8 Llama with the int8 KV cache: ``generate_tokens`` on one
    2,049-token prompt, 64 new tokens, against ``generate_batch``'s greedy
    tokens, with the time to the first token and the ms a step;
    ``generate_iterable`` over the 4 prompts; ``async_generate_tokens``."""
    import asyncio

    prompts = make_prompts(vocab, GEN_PROMPT, 5)
    kw = dict(max_length=FILE_STREAM_NEW, min_length=FILE_STREAM_NEW,
              include_prompt_in_result=False)
    out = {}
    with environ(CT2TPU_KV_CACHE="int8"):
        ref = gen.generate_batch(prompts[:1], **kw)[0].sequences_ids[0]
        plain = {}
        with watched(logs, plain):
            import torch

            torch.cuda.synchronize()
            start = time.perf_counter()
            stream = gen.generate_tokens(prompts[0], **kw)
            first = next(stream)
            ttft = time.perf_counter() - start
            steps = [first] + list(stream)
            seconds = time.perf_counter() - start
            counts = tt.launch_counts()
        check_path("file_helpers generate_tokens", counts,
                   ["matmul_w8a8", "flash_attention", "decode_attention_int8", "fused_norm"],
                   plain, checks)
        ids = [s.token_id for s in steps]
        checks(ids == ref and steps[-1].is_last,
               f"file_helpers generate_tokens: the {len(ids)} streamed tokens equal "
               "generate_batch's greedy ones")
        out["generate_tokens"] = {
            "prompt": GEN_PROMPT, "new_tokens": len(ids), "seconds": seconds,
            "time_to_first_token_ms": ttft * 1e3,
            "ms_per_step_after_first": (seconds - ttft) / max(len(ids) - 1, 1) * 1e3,
            "launches": counts}

        small = dict(kw, max_length=FILE_ITERABLE_NEW, min_length=FILE_ITERABLE_NEW)
        ref_all = gen.generate_batch(prompts, max_batch_size=2, **small)
        plain = {}
        with watched(logs, plain):
            it, seconds = synced_seconds(lambda: list(gen.generate_iterable(
                iter(prompts), max_batch_size=2, **small)))
            counts = tt.launch_counts()
        check_path("file_helpers generate_iterable", counts,
                   ["matmul_w8a8", "flash_attention", "decode_attention_int8", "fused_norm"],
                   plain, checks)
        checks([r.sequences_ids for r in it] == [r.sequences_ids for r in ref_all],
               "file_helpers generate_iterable: generate_batch's sequences, in order")
        out["generate_iterable"] = {"prompts": len(prompts), "new_tokens": FILE_ITERABLE_NEW,
                                    "seconds": seconds, "launches": counts}

        async def collect():
            return [s.token_id async for s in gen.async_generate_tokens(prompts[1], **small)]

        # Against the same prompt alone: a batch of one runs other kernel
        # plans than a batch of two, and 32 random int8 layers part them.
        ref_one = gen.generate_batch(prompts[1:2], **small)[0].sequences_ids[0]
        streamed, seconds = synced_seconds(lambda: asyncio.run(collect()))
        checks(streamed == ref_one,
               "file_helpers async_generate_tokens: generate_batch's tokens")
        out["async_generate_tokens"] = {"new_tokens": len(streamed), "seconds": seconds}
    emit({"phase": "file_helpers_generator", "layers": len(gen.model.arch.decoder.layers),
          **out})


def whisper_features(batch, frames, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((batch, WHISPER_LARGE_V3["n_mels"], frames), generator=g,
                       device="cuda")


def timestamps_well_formed(tokens, ts_begin, eot_id, max_initial=50):
    """Whether the tokens sampled after a timestamped Whisper prompt keep
    the timestamp rules that show in the output (reference:
    src/models/whisper.cc:742-865): a timestamp first, at most
    ``max_initial`` past the first; that one stands as a pair, so no
    timestamp follows it; no timestamp after a pair, no text token after a
    lone timestamp; a pair's second timestamp not below its first, any
    other above every earlier one; no ``<|notimestamps|>``. Whether a pair
    appears at all is the model's choice."""
    if not tokens or not ts_begin <= tokens[0] <= ts_begin + max_initial:
        return False
    latest = tokens[0]
    for i in range(1, len(tokens)):
        x, last = tokens[i], tokens[i - 1]
        penult = tokens[i - 2] if i >= 2 else last  # the first timestamp stands as a pair
        if x == ts_begin - 1:  # <|notimestamps|>
            return False
        if last >= ts_begin and penult >= ts_begin:
            bad = x >= ts_begin  # text after a pair
        elif last >= ts_begin:
            bad = x < eot_id or ts_begin <= x < last  # no text after a lone timestamp
        else:
            bad = ts_begin <= x <= latest  # a new timestamp goes past every earlier one
        if bad:
            return False
        if x >= ts_begin:
            latest = x
    return True


def whisper_prompts(vocab):
    ids = {t: vocab.index(t) for t in ("<|startoftranscript|>", "<|en|>", "<|transcribe|>",
                                       "<|notimestamps|>", "<|startofprev|>")}
    sot = ["<|startoftranscript|>", "<|en|>", "<|transcribe|>"]
    prev = (["<|startofprev|>"] + [f"w{100 + 7 * i}" for i in range(WHISPER_PREV_TOKENS - 4)]
            + sot)
    return ids, sot, prev, sot + ["<|notimestamps|>"]


def whisper_phase(tt, work, checks, logs):
    """Whisper-large-v3's widths (``WHISPER_LARGE_V3``) at ``WHISPER_LAYERS`` +
    ``WHISPER_LAYERS`` layers, in int8 with
    the int8 KV cache: ``encode`` of 4 x 30 s, ``generate`` at beam 5 with
    timestamps (the cached prefill of its prompt, the gather kernel every
    step, the decode kernel, the W8A8 projection at N 51,866), the
    ``<|startofprev|>`` call with the no-speech probability, a greedy
    ``<|notimestamps|>`` call, ``detect_language``, ``align``; then
    ``encode`` with ``flash_attention=True`` fed the plain run's int8
    activations."""
    import numpy as np
    import torch
    import ctranslate2_tpu_torch.ops.linear as L
    from ctranslate2_tpu_torch.models import transformer as T

    t0 = time.perf_counter()
    mf, vocab = build_whisper_modelfile(WHISPER_LAYERS)
    path = save_whisper(mf, vocab, os.path.join(work, "whisper"))
    del mf
    emit({"phase": "whisper_model", "config": {**{k: v for k, v in WHISPER_LARGE_V3.items()
                                                  if k != "alignment_heads"},
                                               "layers": WHISPER_LAYERS},
          "vocabulary": len(vocab), "seconds": time.perf_counter() - t0})
    ids, sot, prev, no_ts = whisper_prompts(vocab)
    ts_begin = ids["<|notimestamps|>"] + 1
    B = SPEECH_BATCH
    out = {}
    with environ(CT2TPU_KV_CACHE="int8"):
        wh = tt.Whisper(path, compute_type="int8")
        feats = whisper_features(B, WHISPER_FRAMES, 1)
        wh.encode(feats[:1])  # warm-up
        recorded = []
        with patched(L, "int8_activations", record_quantized(recorded)):
            memory, _, counts, peak = arch_call("whisper encode", tt, lambda: wh.encode(feats),
                                                ["matmul_w8a8", "fused_norm"], logs, checks)
        _, seconds = synced_seconds(lambda: wh.encode(feats))
        checks(tuple(memory.shape) == (B, WHISPER_FRAMES // 2, WHISPER_LARGE_V3["d_model"])
               and bool(torch.isfinite(memory).all()),
               f"whisper encode: finite [4, 1500, 1280] ({tuple(memory.shape)})")
        out["encode"] = {"features": list(feats.shape), "ms": seconds * 1e3,
                         "seconds_per_30s_audio": seconds / B, "launches": counts,
                         "peak_memory_bytes": peak}

        calls = {"beam5_timestamps": ([sot] * B, dict(beam_size=5,
                                                       max_length=WHISPER_MAX_LENGTH)),
                 "previous_text_no_speech": ([prev] * B, dict(
                     beam_size=5, return_no_speech_prob=True,
                     max_length=WHISPER_SHORT_LENGTH)),
                 "greedy_no_timestamps": ([no_ts] * B, dict(
                     beam_size=1, max_length=WHISPER_SHORT_LENGTH))}
        for label, (prompts, kw) in calls.items():
            stats, wrap = _timed_forwards(T)
            kernels = ["matmul_w8a8", "fused_norm", "decode_attention_int8"]
            if kw["beam_size"] > 1:
                kernels.append("gather_rows_fused")
            with patched(T, "decoder_forward", wrap):
                res, seconds, counts, peak = arch_call(
                    f"whisper generate {label}", tt,
                    lambda: wh.generate(memory, prompts, return_scores=True, **kw),
                    kernels, logs, checks)
            seqs = [r.sequences_ids[0] for r in res]
            tokens = sum(len(s) for s in seqs)
            stamps = [[t for t in s if t >= ts_begin] for s in seqs]
            ok = len(res) == B and all(math.isfinite(r.scores[0]) for r in res)
            if label == "greedy_no_timestamps":
                ok = ok and not any(stamps)
            else:
                ok = ok and all(s == sorted(s) for s in stamps)
            if kw.get("return_no_speech_prob"):
                ok = ok and all(0.0 < r.no_speech_prob < 1.0 for r in res)
            checks(ok, f"whisper generate {label}: finite scores, timestamps by the rules")
            decode_s = seconds - stats["prefill_s"]
            out[label] = {
                "prompt_tokens": len(prompts[0]), "beam": kw["beam_size"],
                "max_length": kw["max_length"],
                "tokens": tokens, "seconds": seconds, "prefill_ms": stats["prefill_s"] * 1e3,
                "decode_steps": stats["steps"],
                "decode_ms_per_step": decode_s / max(stats["steps"], 1) * 1e3,
                "tokens_per_s": tokens / seconds, "timestamp_tokens": sum(map(len, stamps)),
                "no_speech_prob": [r.no_speech_prob for r in res] if kw.get(
                    "return_no_speech_prob") else None,
                "launches": counts, "peak_memory_bytes": peak}

        langs, seconds, counts, _ = arch_call(
            "whisper detect_language", tt, lambda: wh.detect_language(memory),
            ["matmul_w8a8", "fused_norm", "decode_attention_int8"], logs, checks)
        checks(all(len(p) == WHISPER_LARGE_V3["languages"]
                   and abs(sum(x for _, x in p) - 1.0) < 1e-3 for p in langs),
               "whisper detect_language: 100 probabilities summing to 1")
        out["detect_language"] = {"ms": seconds * 1e3, "top": langs[0][:3], "launches": counts}

        texts = [[int(t) for t in np.random.default_rng(40 + b).integers(
            100, 50000, WHISPER_ALIGN_TOKENS)] for b in range(B)]
        start = [ids[t] for t in sot]
        al, seconds, counts, peak = arch_call(
            "whisper align", tt, lambda: wh.align(memory, start, texts, WHISPER_FRAMES),
            ["matmul_w8a8", "fused_norm"], logs, checks)
        checks(all(len(a.text_token_probs) == WHISPER_ALIGN_TOKENS and a.alignments
                   and a.alignments[-1][1] == WHISPER_FRAMES // 2 - 1 for a in al),
               "whisper align: 32 token probabilities and a full warp path a row")
        out["align"] = {"ms": seconds * 1e3, "texts": B, "tokens": WHISPER_ALIGN_TOKENS,
                        "launches": counts, "peak_memory_bytes": peak}
        del wh
        free_card()

        # The encoder with flash_attention=True, fed the plain run's int8
        # activations: only the attention outputs may differ.
        wf = tt.Whisper(path, compute_type="int8", flash_attention=True)
        replay = ReplayQuantized(recorded)
        with patched(L, "int8_activations", replay):
            fmem, seconds, counts, _ = arch_call(
                "whisper encode flash", tt, lambda: wf.encode(feats),
                ["matmul_w8a8", "fused_norm", "flash_attention"], logs, checks)
        layers = WHISPER_LAYERS
        checks(replay.calls == len(recorded) and counts["flash_attention"] == layers,
               f"whisper encode flash: {layers} flash launches, the same linears "
               f"({replay.calls} of {len(recorded)})")
        checks(replay.calls_differing <= layers and replay.max_step <= 1
               and replay.worst_share <= FED_STEP_SHARE,
               f"whisper encode flash: only the attention outputs differ, by at most "
               f"one int8 step on at most {FED_STEP_SHARE} of the entries "
               f"({replay.calls_differing}, {replay.max_step}, {replay.worst_share})")
        checks(bool(torch.isfinite(fmem).all()), "whisper encode flash: finite")
        _, fseconds = synced_seconds(lambda: wf.encode(feats))
        out["encode_flash"] = {"ms": fseconds * 1e3, "ms_fed": seconds * 1e3,
                               "launches": counts,
                               "linears_with_differing_inputs": replay.calls_differing,
                               "int8_max_step": replay.max_step,
                               "worst_linear_share_differing": replay.worst_share}
        del wf, memory, fmem
    emit({"phase": "whisper", "model": "WHISPER_LARGE_V3", "compute_type": "int8",
          "kv_cache": "int8", "batch": B, **out})
    free_card()


def wav2vec2_phase(tt, checks, logs):
    """Wav2Vec2 at wav2vec2-large-lv60's widths in int8: ``encode`` of 8 x
    20 s of 16 kHz audio (999 frames), then with ``flash_attention=True``
    fed the first run's int8 activations."""
    import torch
    import ctranslate2_tpu_torch.ops.linear as L

    t0 = time.perf_counter()
    mf = build_wav2vec2_modelfile(WAV2VEC2_LARGE["layers"])
    emit({"phase": "wav2vec2_model", "config": WAV2VEC2_LARGE,
          "seconds": time.perf_counter() - t0})
    g = torch.Generator(device="cuda").manual_seed(2)
    audio = torch.randn((W2V_BATCH, 1, W2V_SAMPLES), generator=g, device="cuda")
    w = tt.Wav2Vec2(mf, compute_type="int8")
    w.encode(audio[:1])  # warm-up
    recorded = []
    with patched(L, "int8_activations", record_quantized(recorded)):
        logits, _, counts, peak = arch_call("wav2vec2 encode", tt, lambda: w.encode(audio),
                                            ["matmul_w8a8", "fused_norm"], logs, checks)
    _, seconds = synced_seconds(lambda: w.encode(audio))
    checks(tuple(logits.shape) == (W2V_BATCH, 999, WAV2VEC2_LARGE["vocab"])
           and bool(torch.isfinite(logits).all()),
           f"wav2vec2 encode: finite [8, 999, 32] logits ({tuple(logits.shape)})")
    del w
    free_card()
    wf = tt.Wav2Vec2(mf, compute_type="int8", flash_attention=True)
    replay = ReplayQuantized(recorded)
    with patched(L, "int8_activations", replay):
        flogits, _, fcounts, _ = arch_call(
            "wav2vec2 encode flash", tt, lambda: wf.encode(audio),
            ["matmul_w8a8", "fused_norm", "flash_attention"], logs, checks)
    layers = WAV2VEC2_LARGE["layers"]
    checks(replay.calls == len(recorded) and fcounts["flash_attention"] == layers
           and replay.calls_differing <= layers and replay.max_step <= 1
           and replay.worst_share <= FED_STEP_SHARE,
           f"wav2vec2 encode flash: {layers} flash launches; fed, only the attention "
           f"outputs differ by at most one int8 step ({replay.calls_differing}, "
           f"{replay.max_step}, {replay.worst_share})")
    _, fseconds = synced_seconds(lambda: wf.encode(audio))
    emit({"phase": "wav2vec2", "model": "WAV2VEC2_LARGE", "compute_type": "int8",
          "audio": list(audio.shape), "frames": logits.shape[1], "seconds": seconds,
          "sequences_per_s": W2V_BATCH / seconds, "flash_seconds": fseconds,
          "flash_sequences_per_s": W2V_BATCH / fseconds, "launches": counts,
          "flash_launches": fcounts, "peak_memory_bytes": peak,
          "flash_fed": {"linears_with_differing_inputs": replay.calls_differing,
                        "int8_max_step": replay.max_step,
                        "worst_linear_share_differing": replay.worst_share}})
    del wf, mf, logits, flogits
    free_card()


def w2v_bert_phase(tt, checks, logs):
    """Wav2Vec2Bert at w2v-bert-2.0's widths in int8: ``encode`` of 8 x 1,000
    frames of 160 features."""
    import torch

    t0 = time.perf_counter()
    mf = build_w2v_bert_modelfile(W2V_BERT_2["layers"])
    emit({"phase": "w2v_bert_model", "config": W2V_BERT_2,
          "seconds": time.perf_counter() - t0})
    g = torch.Generator(device="cuda").manual_seed(3)
    feats = torch.randn((W2V_BERT_BATCH, W2V_BERT_FRAMES, W2V_BERT_2["input_dim"]),
                        generator=g, device="cuda")
    enc = tt.Wav2Vec2Bert(mf, compute_type="int8")
    enc.encode(feats[:1])  # warm-up
    logits, _, counts, peak = arch_call("w2v_bert encode", tt, lambda: enc.encode(feats),
                                        ["matmul_w8a8", "fused_norm"], logs, checks)
    _, seconds = synced_seconds(lambda: enc.encode(feats))
    checks(tuple(logits.shape) == (W2V_BERT_BATCH, W2V_BERT_FRAMES // 2, W2V_BERT_2["vocab"])
           and bool(torch.isfinite(logits).all()),
           f"w2v_bert encode: finite [8, 500, 32] logits ({tuple(logits.shape)})")
    emit({"phase": "w2v_bert", "model": "W2V_BERT_2", "compute_type": "int8",
          "features": list(feats.shape), "seconds": seconds,
          "sequences_per_s": W2V_BERT_BATCH / seconds, "launches": counts,
          "peak_memory_bytes": peak})
    del enc, mf, logits
    free_card()


def speech_card_vs_cpu(tt, work, checks):
    """At ``AB_LAYERS`` layers of the three geometries, float32: the card
    (the norm kernel, the gather kernel, flash where asked) against the port
    on the CPU. Whisper's tokens identical (beam 5 with timestamps, the
    ``<|startofprev|>`` call, greedy), its encoder output, no-speech and
    language probabilities and the Wav2Vec2 / W2V-BERT logits within
    ``LOGPROB_TOL``, the alignments identical and their probabilities within
    it."""
    import numpy as np
    import torch

    out = {}
    mf, vocab = build_whisper_modelfile(AB_LAYERS)
    path = save_whisper(mf, vocab, os.path.join(work, "whisper_ab"))
    del mf
    card = tt.Whisper(path, compute_type="float32")
    flash = tt.Whisper(path, compute_type="float32", flash_attention=True)
    cpu = tt.Whisper(path, device="cpu", compute_type="float32")
    feats = whisper_features(AB_WHISPER_BATCH, WHISPER_FRAMES, 4)
    mem = card.encode(feats)
    mem_cpu = cpu.encode(feats.cpu())
    d_enc = (mem.cpu() - mem_cpu).abs().max().item()
    fmem = flash.encode(feats)
    d_flash = (fmem.cpu() - mem_cpu).abs().max().item()
    checks(d_enc <= LOGPROB_TOL and d_flash <= LOGPROB_TOL,
           f"speech_card_vs_cpu whisper encode within {LOGPROB_TOL} ({d_enc}; "
           f"flash {d_flash})")
    ids, sot, prev, no_ts = whisper_prompts(vocab)
    gens = {}
    for label, (prompt, kw) in {
            "beam5_timestamps": (sot, dict(beam_size=5)),
            "previous_text_no_speech": (prev, dict(beam_size=5, return_no_speech_prob=True)),
            "greedy_no_timestamps": (no_ts, dict(beam_size=1))}.items():
        opts = dict(max_length=AB_WHISPER_MAX_LENGTH, return_scores=True, **kw)
        b = cpu.generate(mem_cpu, [prompt] * AB_WHISPER_BATCH, asynchronous=True, **opts)
        a = card.generate(mem, [prompt] * AB_WHISPER_BATCH, **opts)
        b = [r.result() for r in b]
        same = [x.sequences_ids for x in a] == [x.sequences_ids for x in b]
        diff = max(abs(x.scores[0] - y.scores[0]) for x, y in zip(a, b))
        ns = max(abs(x.no_speech_prob - y.no_speech_prob) for x, y in zip(a, b))
        checks(same and diff <= LOGPROB_TOL and ns <= LOGPROB_TOL,
               f"speech_card_vs_cpu whisper {label}: identical tokens, scores and "
               f"no-speech probabilities within {LOGPROB_TOL} ({same}, {diff}, {ns})")
        gens[label] = {"identical": same, "score_max_abs_diff": diff,
                       "no_speech_max_abs_diff": ns,
                       "tokens": sum(len(x.sequences_ids[0]) for x in a)}
    la, lb = card.detect_language(mem), cpu.detect_language(mem_cpu)
    d_lang = max(abs(dict(xa)[t] - p) for xa, xb in zip(la, lb) for t, p in xb)
    checks(d_lang <= LOGPROB_TOL, f"speech_card_vs_cpu whisper detect_language "
                                  f"within {LOGPROB_TOL} ({d_lang})")
    texts = [[int(t) for t in np.random.default_rng(50 + b).integers(100, 50000, 16)]
             for b in range(AB_WHISPER_BATCH)]
    start = [ids[t] for t in sot]
    aa = card.align(mem, start, texts, [WHISPER_FRAMES, WHISPER_FRAMES // 2])
    ab = cpu.align(mem_cpu, start, texts, [WHISPER_FRAMES, WHISPER_FRAMES // 2])
    same_al = [x.alignments for x in aa] == [x.alignments for x in ab]
    d_al = max(abs(p - q) for x, y in zip(aa, ab)
               for p, q in zip(x.text_token_probs, y.text_token_probs))
    checks(same_al and d_al <= LOGPROB_TOL,
           f"speech_card_vs_cpu whisper align: identical alignments, probabilities "
           f"within {LOGPROB_TOL} ({same_al}, {d_al})")
    out["whisper"] = {"encode_max_abs_diff": d_enc, "encode_flash_max_abs_diff": d_flash,
                      "generate": gens, "detect_language_max_abs_diff": d_lang,
                      "align_identical": same_al, "align_prob_max_abs_diff": d_al}
    del card, flash, cpu, mem, fmem
    free_card()

    mf = build_wav2vec2_modelfile(AB_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(5)
    audio = torch.randn((2, 1, AB_W2V_SAMPLES), generator=g, device="cuda")
    ref = tt.Wav2Vec2(mf, device="cpu", compute_type="float32").encode(audio.cpu())
    d = {}
    for flag in (False, True):
        w = tt.Wav2Vec2(mf, compute_type="float32", flash_attention=flag)
        d[flag] = (w.encode(audio, to_cpu=True) - ref).abs().max().item()
    checks(max(d.values()) <= LOGPROB_TOL,
           f"speech_card_vs_cpu wav2vec2 logits within {LOGPROB_TOL} ({d})")
    out["wav2vec2"] = {"logits_max_abs_diff": d[False], "flash_logits_max_abs_diff": d[True]}

    mf = build_w2v_bert_modelfile(AB_LAYERS)
    feats = torch.randn((2, W2V_BERT_FRAMES, W2V_BERT_2["input_dim"]), generator=g,
                        device="cuda")
    ref = tt.Wav2Vec2Bert(mf, device="cpu", compute_type="float32").encode(feats.cpu())
    dd = (tt.Wav2Vec2Bert(mf, compute_type="float32").encode(feats, to_cpu=True)
          - ref).abs().max().item()
    checks(dd <= LOGPROB_TOL, f"speech_card_vs_cpu w2v_bert logits within "
                              f"{LOGPROB_TOL} ({dd})")
    out["w2v_bert"] = {"logits_max_abs_diff": dd}
    emit({"phase": "speech_card_vs_cpu", "layers": AB_LAYERS, "compute_type": "float32", **out})
    free_card()


# ---------------------------------------------------------------------------
# Serving: model residency, the continuous batcher, the micro-batching
# scheduler.
# ---------------------------------------------------------------------------

SERVE_SLOTS = 8
# The Generator's side paths (sampling, the host loops, the file helpers and
# this serving phase) run on a SIDE_LAYERS-layer subset of the main path's
# file: with them at 32 layers the whole script took 1,251.9 s on the H100
# (PERF.md section 4).
SIDE_LAYERS = LLAMA["layers"] // 8
SERVE_CAPACITY = 2304
SERVE_STEPS = 8  # steps_per_sync
SERVE_REQUESTS = 48
SERVE_LONG_PROMPT = 2048  # every fourth prompt: its admit prefill takes flash
SERVE_SHORT_PROMPT = (16, 512)
SERVE_NEW = ((4, 16), (64, 128))  # short and long replies, as tools/bench_serving.py
SERVE_LONG_SHARE = 0.3  # of replies drawn long, as tools/bench_serving.py
SERVE_SEED = 16
SERVE_PREFILL_BUCKET = 16  # the admit pads a prompt to a multiple of this
# The batcher's first token of a request against a teacher-forced prefill
# of its prompt alone, padded alike: the same kernels at the same shapes,
# 0.0 apart over the 48 requests on an H100 80GB HBM3. Prompts batched
# by padded length would not be: a batch changes the kernels' rounding,
# and 32 random int8 layers amplify it.
SERVE_FIRST_LOGPROB_TOL = 1e-6
RESIDENCY_PROMPT = 64
RESIDENCY_NEW = 16
SERVE_AB_PROMPTS = (16, 24, 19, 21, 17, 23)  # serving_card_vs_cpu prompt lengths
SERVE_AB_NEW = 8


def serving_traffic(vocab_size, seed=SERVE_SEED):
    """The serving phase's requests: (prompt ids, new tokens), a quarter
    of the prompts exactly ``SERVE_LONG_PROMPT`` long (every fourth), the
    rest uniform in ``SERVE_SHORT_PROMPT``; replies bimodal."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for i in range(SERVE_REQUESTS):
        n = (SERVE_LONG_PROMPT if i % 4 == 3
             else int(rng.integers(SERVE_SHORT_PROMPT[0], SERVE_SHORT_PROMPT[1] + 1)))
        lo, hi = SERVE_NEW[int(rng.random() < SERVE_LONG_SHARE)]
        prompt = [int(t) for t in rng.integers(10, vocab_size - 10, n)]
        out.append((prompt, int(rng.integers(lo, hi + 1))))
    return out


def _percentiles(values):
    import numpy as np

    v = np.asarray(values, np.float64) * 1e3
    return {"p50_ms": float(np.percentile(v, 50)), "p95_ms": float(np.percentile(v, 95)),
            "mean_ms": float(v.mean())}


def _serving_batcher(tt, gen, depth, **kw):
    with environ(CT2TPU_KV_CACHE="int8"):
        return tt.ContinuousBatcher(gen, num_slots=SERVE_SLOTS, capacity=SERVE_CAPACITY,
                                    steps_per_sync=SERVE_STEPS, pipeline_depth=depth,
                                    prefill_bucket=SERVE_PREFILL_BUCKET, **kw)


def _block_timer(cb):
    """Patches a batcher's consume and admit on the instance; returns the
    list that gets (time, admits since the previous consume) at every
    consumed block."""
    consumes, admits = [], [0]
    consume, admit = cb._consume_any, cb._prefill_into_slot

    def timed(handle):
        consume(handle)
        consumes.append((time.perf_counter(), admits[0]))
        admits[0] = 0

    def counted(slot, req):
        admits[0] += 1
        return admit(slot, req)

    cb._consume_any, cb._prefill_into_slot = timed, counted
    return consumes


def _quiet_block_ms(consumes):
    """The median time between two consumed blocks with no admit between
    them (ms), and how many such blocks there were."""
    quiet = sorted(b - a for (a, _), (b, k) in zip(consumes, consumes[1:]) if k == 0)
    return (quiet[len(quiet) // 2] * 1e3 if quiet else None), len(quiet)


def _profile_block(cb, admit, label, steps):
    """One block of a stopped batcher, profiled alone: ``admit(cb)`` fills
    its slots, one block warms up, the next is profiled. Returns the
    launches a step and the card's busy share."""
    cb.close()
    active = admit(cb)
    cb._consume_any(cb._dispatch_any(active))  # warm-up
    prof = profile_call(lambda: cb._consume_any(cb._dispatch_any(active)), label)
    return {"launches_per_decode_step": prof["kernel_launches_profiled"] / steps,
            "device_busy_share": prof["device_busy_share"],
            "wall_ms_profiled": prof["wall_ms_profiled"],
            "top_device_ms": prof["top_device_ms"]}


def serve_run(tt, gen, traffic, depth, logs, checks, label):
    """All requests submitted at once to a batcher of ``pipeline_depth``
    ``depth``, after a warm-up request; every kernel's call shapes logged
    and its plain version's calls on the card counted. Returns the run's
    line (and the per-request first tokens and scores)."""
    import torch

    cb = _serving_batcher(tt, gen, depth)
    consumes = _block_timer(cb)
    n = len(traffic)
    first, streamed, done = [None] * n, [[] for _ in traffic], [None] * n

    def on_token(i):
        def record(sr):
            if first[i] is None:
                first[i] = time.perf_counter()
            streamed[i].append((sr.token_id, sr.score))
            return False
        return record

    plain = {}
    try:
        cb.submit(traffic[0][0][:64], max_length=SERVE_STEPS).result(timeout=600)
        steps0, blocks0, slot_steps0 = cb.num_steps, cb._blocks, cb._slot_steps
        consumes.clear()
        with watched(logs, plain):
            t0 = time.perf_counter()
            futures = [cb.submit([gen._vocab.to_token(t) for t in p], max_length=new,
                                 callback=on_token(i))
                       for i, (p, new) in enumerate(traffic)]
            for i, f in enumerate(futures):
                f.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
            results = [f.result(timeout=1200) for f in futures]
            seconds = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = tt.launch_counts()
        steps = cb.num_steps - steps0
        blocks = cb._blocks - blocks0
        occupancy = (cb._slot_steps - slot_steps0) / max(steps * SERVE_SLOTS, 1)
    finally:
        cb.close()
    ids = [r.sequences_ids[0] for r in results]
    tokens = sum(len(x) for x in ids)
    eos = gen._vocab.eos_id
    ended = [len(x) == new or (len(x) < new and streamed[i][len(x)][0] == eos)
             for i, (x, (_, new)) in enumerate(zip(ids, traffic))]
    checks(all(ended), f"{label}: every request ends at its max_length or at an end "
                       f"token ({sum(ended)}/{n})")
    checks(all(math.isfinite(r.scores[0]) for r in results),
           f"{label}: every score is finite")
    # A short request admitted while a long one decodes finishes first.
    overtakes = sum(1 for i in range(n) for j in range(n)
                    if traffic[i][1] >= SERVE_NEW[1][0] and traffic[j][1] <= SERVE_NEW[0][1]
                    and first[i] < first[j] < done[i] and done[j] < done[i])
    checks(overtakes > 0, f"{label}: a short request admitted mid-decode finished "
                          f"before a long one ({overtakes} pairs)")
    check_path(label, counts, ("matmul_w8a8", "flash_attention", "decode_attention_int8",
                               "fused_norm"), plain, checks)
    layers = len(gen.model.arch.decoder.layers)
    checks(counts["decode_attention_int8"] == layers * steps,
           f"{label}: one decode launch a layer and step ({counts['decode_attention_int8']} "
           f"for {steps} steps)")
    block_ms, quiet = _quiet_block_ms(consumes)
    line = {"phase": label, "pipeline_depth": depth, "requests": n, "seconds": seconds,
            "generated_tokens": tokens, "tokens_per_s": tokens / seconds,
            "time_to_first_token": _percentiles([f - t0 for f in first]),
            "request_latency": _percentiles([d - t0 for d in done]),
            "mean_slot_occupancy": occupancy, "decode_steps": steps, "blocks": blocks,
            "ms_per_block": block_ms, "blocks_timed_without_admits": quiet,
            "short_before_long_pairs": overtakes, "launches": counts,
            "plain_calls_on_card": plain}
    return line, [s[0] for s in streamed]


def serve_static_run(tt, gen, traffic, depth):
    """Run-to-completion batching of the same requests on the same engine:
    batches of ``SERVE_SLOTS`` in submission order, each admitted whole and
    run until its longest reply ends before the next one starts; every
    request available at the start, so a batch's requests finish when the
    batch does. (``generate_batch`` in such batches, as
    ``tools/bench_serving.py`` runs them, prefills only the shortest prompt
    and forces every other prompt token through a decode step: with
    2,048-token prompts beside 16-token ones, about 2,000 steps a batch.)"""
    import torch

    cb = _serving_batcher(tt, gen, depth)
    try:
        cb.submit([gen._vocab.to_token(t) for t in traffic[0][0][:64]],
                  max_length=SERVE_STEPS).result(timeout=600)
        firsts, latencies, tokens = [], [], 0
        t0 = time.perf_counter()
        for b in range(0, len(traffic), SERVE_SLOTS):
            group = traffic[b:b + SERVE_SLOTS]
            seen = [None] * len(group)

            def on_token(i):
                def record(sr):
                    if seen[i] is None:
                        seen[i] = time.perf_counter()
                    return False
                return record

            futures = [cb.submit([gen._vocab.to_token(t) for t in p], max_length=new,
                                 callback=on_token(i))
                       for i, (p, new) in enumerate(group)]
            tokens += sum(len(f.result(timeout=1200).sequences_ids[0]) for f in futures)
            end = time.perf_counter() - t0
            latencies += [end] * len(group)
            firsts += [s - t0 for s in seen]
        seconds = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        cb.close()
    return {"schedule": "run to completion, batches of 8 in submission order",
            "pipeline_depth": cb._depth, "seconds": seconds, "generated_tokens": tokens, "tokens_per_s": tokens / seconds,
            "time_to_first_token": _percentiles(firsts),
            "request_latency": _percentiles(latencies)}


def profile_serving_block(tt, gen, traffic):
    """One decode block of a full batcher, profiled alone: its kernel
    launches a step and the card's busy share. The batcher's thread is
    stopped; the block is driven from here after admitting ``SERVE_SLOTS``
    requests."""
    return _profile_block(_serving_batcher(tt, gen, 1), lambda cb: _admit_traffic(cb, traffic),
                          "serving_block", SERVE_STEPS)


def _admit_traffic(cb, traffic):
    """Admits the first ``SERVE_SLOTS`` prompts of ``traffic`` into a stopped
    batcher's slots, each to decode 512 tokens; returns the slots."""
    from ctranslate2_tpu_torch.runtime.continuous import _Request

    for slot, (p, _) in enumerate(traffic[:SERVE_SLOTS]):
        cb._prefill_into_slot(slot, _Request(prompt_ids=list(p), max_length=512,
                                             min_length=512))
    return list(range(SERVE_SLOTS))


def serving_first_tokens(gen, traffic, firsts, checks):
    """Each request's first token and its log-prob against the same
    computation outside the batcher: a teacher-forced prefill of the prompt
    alone (``decoder_forward`` with ``fresh_prefill`` and the prompt's
    length, padded to ``SERVE_PREFILL_BUCKET`` as the admit pads it, int8
    KV cache) and the log-softmax of the last prompt position's logits.
    Each prompt goes alone: rows batched together change the kernels'
    rounding, which 32 random int8 layers amplify."""
    import torch
    from ctranslate2_tpu_torch.models import transformer as T

    m = gen.model
    qa = m.policy.quantize_activations
    diffs, same, compared = [], 0, 0
    with environ(CT2TPU_KV_CACHE="int8"):
        m.ensure_consts(SERVE_CAPACITY)
        for (p, _), (tok, score) in zip(traffic, firsts):
            padded = -(-len(p) // SERVE_PREFILL_BUCKET) * SERVE_PREFILL_BUCKET
            ids = torch.zeros((1, padded), dtype=torch.long)
            ids[0, :len(p)] = torch.tensor(p)
            cache = T.init_self_cache(m.arch, 1, padded, dtype=m.kv_dtype, device=m.device,
                                      ring=True)
            h, _ = T.decoder_forward(
                m.arch, m.params, m.consts, ids.to(m.device), 0, cache,
                lengths=torch.tensor([len(p)], device=m.device), quantize_acts=qa,
                out_dtype=m.out_dtype, return_logits=False, fresh_prefill=True)
            lp = torch.log_softmax(
                T.project_logits(m.arch, m.params, h[:, len(p) - 1], qa).float(), -1)[0]
            diffs.append(abs(lp[tok].item() - score))
            top = torch.topk(lp, 2).values
            if (top[0] - top[1]).item() > SERVE_FIRST_LOGPROB_TOL:
                compared += 1
                same += int(lp.argmax().item() == tok)
            del cache, h
    checks(max(diffs) <= SERVE_FIRST_LOGPROB_TOL,
           f"serving: each first token's log-prob within {SERVE_FIRST_LOGPROB_TOL} of "
           f"the teacher-forced prefill's (max {max(diffs)})")
    checks(same == compared, f"serving: the first token is the teacher-forced prefill's "
                             f"wherever its best two are apart ({same}/{compared})")
    return {"reference": "teacher-forced prefill of the prompt alone, padded as the admit",
            "max_abs_logprob_diff": max(diffs), "mean_abs_logprob_diff": sum(diffs) / len(diffs),
            "tolerance": SERVE_FIRST_LOGPROB_TOL, "tokens_compared": compared,
            "tokens_equal": same}


def serving_generator(tt, gen, vocab, checks, logs):
    """The int8 Llama with the int8 KV cache behind ``ContinuousBatcher``
    (8 slots of 2,304, 8 steps a block): the same 48 requests at pipeline
    depth 1 and 2, run to completion in batches of 8, one profiled block,
    and each request's first token against a teacher-forced prefill."""
    traffic = serving_traffic(LLAMA["vocab"])
    runs = {}
    for depth in (1, 2):
        runs[depth], firsts = serve_run(tt, gen, traffic, depth, logs, checks,
                                        f"serving_generator_depth{depth}")
        free_card()
    static = serve_static_run(tt, gen, traffic, None)  # the default depth
    block = profile_serving_block(tt, gen, traffic)
    free_card()
    first = serving_first_tokens(gen, traffic, firsts, checks)
    for depth in (1, 2):
        emit(dict(runs[depth], profiled_block=block if depth == 2 else None))
    best = max((1, 2), key=lambda d: runs[d]["tokens_per_s"])
    emit({"phase": "serving_generator", "compute_type": gen.compute_type,
          "layers": len(gen.model.arch.decoder.layers), "kv_cache": "int8", "slots": SERVE_SLOTS, "capacity": SERVE_CAPACITY,
          "steps_per_sync": SERVE_STEPS, "requests": SERVE_REQUESTS,
          "prompt_tokens": sum(len(p) for p, _ in traffic),
          "long_prompts": sum(len(p) == SERVE_LONG_PROMPT for p, _ in traffic),
          "tokens_per_s_by_depth": {d: runs[d]["tokens_per_s"] for d in (1, 2)},
          "faster_depth": best, "run_to_completion": static,
          "first_tokens_vs_teacher_forced_prefill": first, "profiled_block": block})


def residency_cycle(obj, call, must_free, label, checks):
    """unload_model(to_cpu=True) and load_model() around ``call()``, timed,
    with the card's allocated memory before and after each; then an unload
    without a host copy, whose load_model() must raise."""
    import torch

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree] if torch.is_tensor(tree) else []

    before = call()
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(obj.model.params))
    int8_bytes = sum(t.numel() for t in leaves(obj.model.params) if t.dtype == torch.int8)
    torch.cuda.synchronize()
    loaded = torch.cuda.memory_allocated()
    (_, unload_s) = synced_seconds(lambda: obj.unload_model(to_cpu=True))
    unloaded = torch.cuda.memory_allocated()
    (_, load_s) = synced_seconds(obj.load_model)
    reloaded = torch.cuda.memory_allocated()
    after = call()
    checks(loaded - unloaded >= max(must_free, param_bytes),
           f"{label}: unload_model(to_cpu=True) frees at least the weights' bytes "
           f"({loaded - unloaded} of {max(must_free, param_bytes)} bytes)")
    checks(reloaded - unloaded >= param_bytes,
           f"{label}: load_model() puts the weights back ({reloaded - unloaded} bytes)")
    checks(after == before, f"{label}: the reloaded model gives the same tokens")
    obj.unload_model()
    raised = False
    try:
        obj.load_model()
    except RuntimeError:
        raised = True
    checks(raised, f"{label}: load_model() after unload_model() without a copy raises")
    emit({"phase": f"residency_{label}", "param_bytes": param_bytes,
          "int8_payload_bytes": int8_bytes, "allocated_loaded": loaded,
          "allocated_unloaded": unloaded, "allocated_reloaded": reloaded,
          "unload_seconds": unload_s, "load_seconds": load_s,
          "unload_gbytes_per_s": param_bytes / unload_s / 1e9,
          "load_gbytes_per_s": param_bytes / load_s / 1e9,
          "same_tokens_after_reload": after == before})


def residency_generator(tt, gen, vocab, payload_bytes, checks):
    prompts = make_prompts(vocab, RESIDENCY_PROMPT, 30)
    kw = dict(max_length=RESIDENCY_NEW, min_length=RESIDENCY_NEW,
              include_prompt_in_result=False)
    with environ(CT2TPU_KV_CACHE="int8"):
        residency_cycle(gen, lambda: [r.sequences_ids for r in gen.generate_batch(
            prompts, **kw)], payload_bytes, "generator", checks)


def residency_translator(tt, model_dir, batch, checks):
    tr = tt.Translator(model_dir, compute_type="int8")
    residency_cycle(tr, lambda: [r.hypotheses for r in tr.translate_batch(batch, **OPTS)],
                    0, "translator", checks)
    del tr


def serving_translator(tt, model_dir, batches, checks, logs):
    """``BufferedTranslationWrapper`` and ``translation_scheduler`` on the
    four phase-2 batches, submitted one sentence at a time, against
    ``translate_batch`` of the same sentences."""
    tr = tt.Translator(model_dir, compute_type="int8")
    sents = [s for b in batches[:4] for s in b]
    tr.translate_batch(batches[0], **OPTS)  # warm-up
    ref, batch_s = synced_seconds(
        lambda: tr.translate_batch(sents, max_batch_size=BATCH, **OPTS))
    tokens = sum(len(r.hypotheses[0]) for r in ref)
    out = {"translate_batch": {"seconds": batch_s, "target_tokens_per_s": tokens / batch_s}}
    for label in ("buffered_wrapper", "translation_scheduler"):
        front = (tt.BufferedTranslationWrapper(tr, max_batch_size=BATCH)
                 if label == "buffered_wrapper"
                 else tt.translation_scheduler(tr, max_batch_size=BATCH))
        submit = front.translate_async if label == "buffered_wrapper" else front.submit
        plain = {}
        try:
            with watched(logs, plain):
                got, seconds = synced_seconds(
                    lambda: [f.result(timeout=600) for f in [submit(s, **OPTS)
                                                             for s in sents]])
                counts = tt.launch_counts()
        finally:
            front.close()
        check_path(f"serving_translator {label}", counts, ("matmul_w8a8", "fused_norm"),
                   plain, checks)
        same = sum(g.hypotheses[0] == r.hypotheses[0] for g, r in zip(got, ref))
        checks(same >= FILE_SAME_SHARE * len(sents),
               f"serving_translator {label}: {same} of {len(sents)} hypotheses equal to "
               f"translate_batch's (at least {FILE_SAME_SHARE} of them)")
        toks = sum(len(g.hypotheses[0]) for g in got)
        out[label] = {"seconds": seconds, "target_tokens_per_s": toks / seconds,
                      "hypotheses_equal_to_batch": same, "launches": counts}
    emit({"phase": "serving_translator", "sentences": len(sents), "max_batch_size": BATCH,
          "options": OPTS, **out})
    del tr


@contextlib.contextmanager
def fed_serving_noise():
    """Gives every sampling slot of a batcher, on the card or the CPU, the
    same noise: a CPU ``torch.Generator`` seeded as the slot's own, its
    draws moved to the model's device."""
    import torch
    import ctranslate2_tpu_torch.runtime.continuous as C
    from ctranslate2_tpu_torch.decoding.sampling import draw_gumbel

    def set_sampling(orig):
        def wrapped(self, slot, req):
            orig(self, slot, req)
            if self._gens[slot] is not None:
                g = torch.Generator()
                g.manual_seed(self._gens[slot].initial_seed())
                self._gens[slot] = g
        return wrapped

    def noise(gens, vocab, device):
        return torch.cat([draw_gumbel(g, (1, vocab), "cpu") if g is not None
                          else torch.zeros((1, vocab)) for g in gens]).to(device)

    with patched(C.ContinuousBatcher, "_set_slot_sampling", set_sampling), \
            patched(C, "slot_noise", lambda orig: noise):
        yield


def serving_card_vs_cpu(tt, generators, vocab, checks):
    """At ``AB_LAYERS`` layers, float32: the batcher on the card against the
    batcher on the CPU and against generate_batch on the card, in the float
    and the int8 KV cache, with every per-request option (sampling fed the
    same noise, penalties, suppressed and end tokens, stop sequences,
    min_length, callbacks, ``stream``); and a batcher and a generate_batch
    call at the same time on one model."""
    import numpy as np
    import threading

    card, cpu = generators
    rng = np.random.default_rng(61)
    prompts = [[vocab.to_token(int(t)) for t in rng.integers(10, LLAMA["vocab"] - 10, n)]
               for n in SERVE_AB_PROMPTS]
    base = dict(max_length=SERVE_AB_NEW)
    greedy = [r.sequences_ids[0] for r in card.generate_batch(
        prompts, include_prompt_in_result=False, **base)]

    def recorder(calls):
        def record(sr):
            calls.append(sr.token_id)
            return False
        return record

    reqs = [(prompts[0], base),
            (prompts[1], dict(base, sampling_topk=20, sampling_temperature=0.8, seed=3)),
            (prompts[2], dict(base, repetition_penalty=1.3, no_repeat_ngram_size=2)),
            (prompts[3], dict(base, min_length=6, end_token=[vocab.to_token(greedy[3][1])],
                              suppress_tokens=[vocab.to_token(greedy[3][0])])),
            (prompts[4], dict(base, stop_sequences=[greedy[4][2:4]])),
            (prompts[5], dict(base, sampling_topp=0.9, sampling_temperature=1.2, seed=4))]
    out = {}
    t0 = time.perf_counter()
    for kv in ("", "int8"):
        side = {}
        with environ(CT2TPU_KV_CACHE=kv):
            ref0 = card.generate_batch(prompts[:1], include_prompt_in_result=False,
                                       **base)[0].sequences_ids[0]
        for name, gen in (("card", card), ("cpu", cpu)):
            with environ(CT2TPU_KV_CACHE=kv):
                cb = tt.ContinuousBatcher(gen, num_slots=4, capacity=128, steps_per_sync=4)
            try:
                with fed_serving_noise():
                    calls = [[] for _ in reqs]
                    fs = [cb.submit(p, callback=recorder(calls[i]), **o)
                          for i, (p, o) in enumerate(reqs)]
                    res = [f.result(timeout=600) for f in fs]
                    stream = [s.token_id for s in cb.stream(prompts[0], **base)]
            finally:
                cb.close()
            side[name] = (res, calls, stream)
        (cres, ccalls, cstream), (pres, pcalls, pstream) = side["card"], side["cpu"]
        tol = INT8_KV_LOGPROB_TOL if kv else LOGPROB_TOL
        same = [c.sequences_ids == p.sequences_ids for c, p in zip(cres, pres)]
        diff = max(abs(c.scores[0] - p.scores[0]) for c, p in zip(cres, pres))
        label = f"serving card vs CPU ({'int8' if kv else 'float'} KV)"
        checks(all(same), f"{label}: the batcher's tokens equal on every request ({same})")
        # A score sums up to SERVE_AB_NEW token log-probs.
        checks(diff <= tol * SERVE_AB_NEW,
               f"{label}: scores within {tol} a token (max diff {diff})")
        checks(ccalls == pcalls and cstream == pstream,
               f"{label}: callbacks and stream give the same tokens")
        checks(cres[0].sequences_ids[0] == ref0 and cstream[:len(ref0)] == ref0,
               f"{label}: the greedy request equals generate_batch on the card")
        checks(len(cres[3].sequences_ids[0]) >= 6,
               f"{label}: min_length holds ({len(cres[3].sequences_ids[0])})")
        out["int8_kv" if kv else "float_kv"] = {"max_score_diff": diff, "tolerance": tol,
                                               "same_tokens": same}
    # A batcher and a generate_batch call at the same time on one model.
    with environ(CT2TPU_KV_CACHE="int8"):
        ref = [r.sequences_ids[0] for r in card.generate_batch(
            prompts, include_prompt_in_result=False, **base)]
        cb = tt.ContinuousBatcher(card, num_slots=3, capacity=128, steps_per_sync=2)
        try:
            fs = [cb.submit(p, **base) for p in prompts * 2]
            side_by_side = []
            worker = threading.Thread(target=lambda: side_by_side.append(
                [r.sequences_ids[0] for r in card.generate_batch(
                    prompts, include_prompt_in_result=False, **base)]))
            worker.start()
            served = [f.result(timeout=600).sequences_ids[0] for f in fs]
            worker.join(timeout=600)
        finally:
            cb.close()
    checks(side_by_side and side_by_side[0] == ref,
           "serving: generate_batch beside a running batcher gives its own tokens")
    checks(served[:len(prompts)] == served[len(prompts):],
           "serving: the batcher beside generate_batch serves each prompt alike twice")
    emit({"phase": "serving_card_vs_cpu", "layers": AB_LAYERS, "compute_type": "float32",
          "requests": len(reqs), "new_tokens": SERVE_AB_NEW, **out,
          "concurrent_generate_batch_ok": bool(side_by_side and side_by_side[0] == ref),
          "seconds": time.perf_counter() - t0})


def serving_benches(serve_logs, checks):
    """The serving path's kernel shapes against their plain versions, in
    rows of their own (``"summed": false``): the decode kernel over 8 slots
    with lengths spread over [0, capacity - block] (rows of length 0 and
    near capacity), flash at the 1-row admit prefill, W8A8 and the norm at
    the decode M and at the smallest, median and largest padded prompt and
    2,048; every other W8A8 prefill shape only held bit-equal."""
    import torch
    from ctranslate2_tpu_torch.kernels.quant_matmul import matmul_w8a8, matmul_w8a8_plain

    extra = dict(summed=False, paths="serving_generator")
    bench_decode(serve_logs.get("decode_attention_int8", {}), 0,
                 SERVE_CAPACITY - SERVE_STEPS + 1, checks, **extra)
    free_card()
    bench_flash(serve_logs.get("flash_attention", {}), checks, **extra)
    free_card()

    def pick(shapes, rows_of):
        prefill = sorted({rows_of(k) for k in shapes if rows_of(k) > SERVE_SLOTS})
        keep = {1, SERVE_SLOTS, SERVE_LONG_PROMPT}  # 1: the admit's projection
        if prefill:
            keep |= {prefill[0], prefill[len(prefill) // 2], prefill[-1]}
        return ({k: n for k, n in shapes.items() if rows_of(k) in keep},
                {k: n for k, n in shapes.items() if rows_of(k) not in keep})

    timed, rest = pick(serve_logs.get("matmul_w8a8", {}), lambda k: k[0])
    bench_w8a8(timed, checks, **extra)
    g = torch.Generator(device="cuda").manual_seed(9)
    for (M, K, N) in sorted(rest):
        q = torch.randint(-128, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, device="cuda", dtype=torch.int8)
        a_s = torch.rand(M, generator=g, device="cuda") + 0.5
        w_s = torch.rand(N, generator=g, device="cuda") + 0.5
        checks(torch.equal(matmul_w8a8(q, wq, a_s, w_s), matmul_w8a8_plain(q, wq, a_s, w_s)),
               f"w8a8 bit-equal to plain at the serving prefill shape {(M, K, N)}")
    emit({"phase": "kernel_w8a8_serving_checked", "shapes": sorted(rest)})
    free_card()
    timed, _ = pick(serve_logs.get("fused_norm", {}), lambda k: k[0])
    bench_norm(timed, checks, **extra)
    free_card()


# ---------------------------------------------------------------------------
# Serving, part 2: beam serving, ContinuousTranslator, ContinuousWhisper.
# ---------------------------------------------------------------------------

CT_SLOTS = 64  # ContinuousTranslator: the phase-2 batch size
CT_CAPACITY = 64
CT_SOURCE = 64  # max_source_len: the phase-2 sources are 20-30 tokens
CT_STEPS = 8
CT_PARTED_LOGGED = 16
BEAM_SERVE_WIDTH = 4
BEAM_SERVE_REQUESTS = 16  # the first of serving_traffic's requests
CW_SEGMENTS = 8
CW_SLOTS = 4
CW_BEAM = 5
CW_MAX_LENGTH = 64
CW_CAPACITY = 128
CW_STEPS = 8
BEAM_AB_PROMPTS = (513, 17, 64, 200, 33, 9)  # serving_beam_card_vs_cpu
BEAM_AB_NEW = 8
CW_AB_MAX_LENGTH = 32


def _gather_ms_per_step(cb, checks, label):
    """The gather kernel over the batcher's whole slot cache (every beam
    step's reorder), timed in a CUDA graph, beside its bound: each byte of
    the cache read once and written once."""
    import torch
    from ctranslate2_tpu_torch.models import transformer as T

    rows = torch.arange(cb._num_slots * cb._beam, device="cuda", dtype=torch.int32)
    out = T.cache_gather_rows(cb._cache, rows)
    checks(all(torch.equal(a, b) for la, lb in zip(out, cb._cache) for a, b in
               zip(la.values(), lb.values())), f"{label}: the gather copies the cache")
    del out
    nbytes = sum(a.numel() * a.element_size() for layer in cb._cache for a in layer.values())
    ms = cuda_time_ms(lambda: T.cache_gather_rows(cb._cache, rows), 10)
    return {"ms": ms, "cache_bytes": nbytes, "bound_ms": 2 * nbytes / PEAK_BYTES * 1e3,
            "bound_by": "bytes"}


def _check_beam_launches(label, counts, steps, plain, kernels, checks):
    check_path(label, counts, kernels, plain, checks)
    checks(steps > 0 and counts["gather_rows_fused"] == steps,
           f"{label}: one gather launch a beam step ({counts['gather_rows_fused']} for "
           f"{steps} steps)")


def continuous_translator(tt, model_dir, batches, checks, logs, half_dir):
    """The int8 Transformer-base behind ``ContinuousTranslator``: the 256
    phase-2 sentences submitted at once to ``CT_SLOTS`` slots, beam 2 and
    beam 1, exactly ``MAX_DEC`` target tokens, against ``translate_batch``
    (beam 2, batches of 64) on the same sentences; one profiled block, on
    the model at half its depth (``half_dir``, ``HALF_LAYERS``), and the
    gather over the whole slot cache. Returns the beam-1 run's line and
    hypotheses."""
    import torch
    from ctranslate2_tpu_torch.runtime.continuous import _Request

    tr = tt.Translator(model_dir, compute_type="int8")
    sents = [s for b in batches[:4] for s in b]
    tr.translate_batch(batches[0], **OPTS)  # warm-up
    ref, batch_s = synced_seconds(
        lambda: tr.translate_batch(sents, max_batch_size=BATCH, **OPTS))
    ref_tokens = sum(len(r.hypotheses[0]) for r in ref)
    out = {"translate_batch": {"seconds": batch_s, "target_tokens_per_s": ref_tokens / batch_s}}
    kw = dict(max_length=MAX_DEC, min_length=MAX_DEC)
    for beam in (BEAM, 1):
        label = f"continuous_translator beam {beam}"
        cb = tt.ContinuousTranslator(tr, num_slots=CT_SLOTS, capacity=CT_CAPACITY,
                                     max_source_len=CT_SOURCE, steps_per_sync=CT_STEPS,
                                     beam_size=beam)
        consumes = _block_timer(cb)
        plain = {}
        try:
            cb.submit(sents[0], **kw).result(timeout=600)  # warm-up
            consumes.clear()
            steps0, blocks0 = cb.num_steps, cb._blocks
            with watched(logs, plain):
                got, seconds = synced_seconds(
                    lambda: [f.result(timeout=900) for f in [cb.submit(s, **kw)
                                                             for s in sents]])
                counts = tt.launch_counts()
            steps, blocks = cb.num_steps - steps0, cb._blocks - blocks0
        finally:
            cb.close()
        if beam > 1:
            _check_beam_launches(label, counts, steps, plain,
                                 ("matmul_w8a8", "fused_norm", "gather_rows_fused"), checks)
        else:
            check_path(label, counts, ("matmul_w8a8", "fused_norm"), plain, checks)
        hyps = [g.sequences[0] for g in got]
        checks(all(len(h) == MAX_DEC for h in hyps)
               and all(math.isfinite(g.scores[0]) for g in got),
               f"{label}: {MAX_DEC} target tokens a sentence, finite scores")
        tokens = sum(len(h) for h in hyps)
        block_ms, quiet = _quiet_block_ms(consumes)
        line = {"seconds": seconds, "target_tokens_per_s": tokens / seconds,
                "decode_steps": steps, "blocks": blocks, "ms_per_block": block_ms,
                "blocks_timed_without_admits": quiet, "launches": counts,
                "plain_calls_on_card": plain}
        if beam > 1:
            same = [h == r.hypotheses[0] for h, r in zip(hyps, ref)]
            checks(sum(same) >= FILE_SAME_SHARE * len(sents),
                   f"{label}: {sum(same)} of {len(sents)} hypotheses equal to "
                   f"translate_batch's (at least {FILE_SAME_SHARE} of them)")
            parted = []
            for i in [i for i, s in enumerate(same) if not s][:CT_PARTED_LOGGED]:
                a, b = hyps[i], ref[i].hypotheses[0]
                t = next(j for j in range(min(len(a), len(b))) if a[j] != b[j])
                # The two tokens' teacher-forced log-probs after the common
                # prefix: the gap between the two best candidates there.
                sa, sb = (tr.score_batch([sents[i]], [a[:t + 1]])[0].tokens_score[t],
                          tr.score_batch([sents[i]], [b[:t + 1]])[0].tokens_score[t])
                parted.append({"sentence": i, "step": t, "logprob_gap": abs(sa - sb)})
            line.update(hypotheses_equal_to_batch=sum(same), parted=parted,
                        launches_per_beam_step={k: v / steps for k, v in counts.items()})
        out[f"beam{beam}"] = line
        greedy = (line, hyps)
    def batcher(translator):
        return tt.ContinuousTranslator(translator, num_slots=CT_SLOTS, capacity=CT_CAPACITY,
                                       max_source_len=CT_SOURCE, steps_per_sync=CT_STEPS,
                                       beam_size=BEAM)

    def admit(cb):
        for slot in range(CT_SLOTS):
            ids = cb._src_vocab.tokens_to_ids([sents[slot]])[0]
            cb._prefill_into_slot(slot, _Request(prompt_ids=ids, start_id=cb._start_id, **kw))
        return list(range(CT_SLOTS))

    cb = batcher(tr)
    out["gather_per_step"] = _gather_ms_per_step(cb, checks, "continuous_translator")
    cb.close()
    half = tt.Translator(half_dir, compute_type="int8")
    out["profiled_block"] = dict(
        _profile_block(batcher(half), admit, "continuous_translator_block", CT_STEPS),
        layers=HALF_LAYERS)
    del cb, half
    emit({"phase": "continuous_translator", "compute_type": "int8", "sentences": len(sents),
          "slots": CT_SLOTS, "capacity": CT_CAPACITY, "max_source_len": CT_SOURCE,
          "steps_per_sync": CT_STEPS, "max_length": MAX_DEC, "beam": BEAM, **out})
    del tr
    return greedy


def _serve_traffic(tt, cb, gen, traffic, logs, label, checks, decode_per_step=None):
    """Every request of ``traffic`` submitted at once to ``cb`` after a
    warm-up request, with a streaming callback each (under beam search the
    first delivery is the first committed token). ``decode_per_step``: the
    decode kernel's launches a step (a layer's by default). Returns the
    run's line, the launch counts, the steps, the plain versions' calls on
    the card and each request's streamed (token, score) pairs."""
    import torch

    consumes = _block_timer(cb)
    n = len(traffic)
    first, done, streamed = [None] * n, [None] * n, [[] for _ in traffic]

    def on_token(i):
        def record(sr):
            if first[i] is None:
                first[i] = time.perf_counter()
            streamed[i].append((sr.token_id, sr.score))
            return False
        return record

    plain = {}
    try:
        cb.submit([gen._vocab.to_token(t) for t in traffic[0][0][:64]],
                  max_length=SERVE_STEPS).result(timeout=600)
        consumes.clear()
        steps0, blocks0 = cb.num_steps, cb._blocks
        spec0 = (cb._accepted_tokens, cb._spec_dispatches)
        with watched(logs, plain):
            t0 = time.perf_counter()
            futures = [cb.submit([gen._vocab.to_token(t) for t in p], max_length=new,
                                 callback=on_token(i))
                       for i, (p, new) in enumerate(traffic)]
            for i, f in enumerate(futures):
                f.add_done_callback(lambda f, i=i: done.__setitem__(i, time.perf_counter()))
            results = [f.result(timeout=1200) for f in futures]
            seconds = time.perf_counter() - t0
            torch.cuda.synchronize()
            counts = tt.launch_counts()
        steps, blocks = cb.num_steps - steps0, cb._blocks - blocks0
    finally:
        cb.close()
    ids = [r.sequences_ids[0] for r in results]
    tokens = sum(len(x) for x in ids)
    checks(all(len(x) <= new for x, (_, new) in zip(ids, traffic))
           and all(math.isfinite(r.scores[0]) for r in results),
           f"{label}: every request's best hypothesis within its max_length, finite scores")
    checks(all(f is not None for f in first), f"{label}: every request streamed a token")
    if decode_per_step is None:
        decode_per_step = len(gen.model.arch.decoder.layers)
    checks(counts["decode_attention_int8"] == decode_per_step * steps,
           f"{label}: {decode_per_step} decode launches a step "
           f"({counts['decode_attention_int8']} for {steps} steps)")
    block_ms, quiet = _quiet_block_ms(consumes)
    spec = None
    if cb._spec_k > 1:
        spec = ((cb._accepted_tokens - spec0[0])
                / max(cb._spec_dispatches - spec0[1], 1))
    return {"requests": n, "seconds": seconds, "generated_tokens": tokens,
            "tokens_per_s": tokens / seconds,
            "time_to_first_token": _percentiles([f - t0 for f in first]),
            "request_latency": _percentiles([d - t0 for d in done]),
            "decode_steps": steps, "blocks": blocks, "ms_per_block": block_ms,
            "blocks_timed_without_admits": quiet, "launches": counts,
            "spec_tokens_per_dispatch": spec,
            "plain_calls_on_card": plain}, counts, steps, plain, streamed


def serving_generator_beam(tt, gen, checks, logs, side_gen):
    """The int8 Llama with the int8 KV cache behind
    ``ContinuousBatcher(beam_size=4)`` (``SERVE_SLOTS`` slots of
    ``SERVE_CAPACITY``, ``SERVE_STEPS`` steps a block): the first
    ``BEAM_SERVE_REQUESTS`` requests of ``serving_traffic`` submitted at
    once, then the same requests greedy at depth 1; one profiled beam
    block, on ``side_gen`` (``SIDE_LAYERS`` of the Llama's layers), and the
    gather over the whole slot cache. Returns the greedy
    run's line and its streamed tokens (``serving_generator_spec`` compares
    the speculative runs with them)."""
    traffic = serving_traffic(LLAMA["vocab"])[:BEAM_SERVE_REQUESTS]
    label = f"serving_generator_beam beam {BEAM_SERVE_WIDTH}"
    beam, counts, steps, plain, *_ = _serve_traffic(
        tt, _serving_batcher(tt, gen, 1, beam_size=BEAM_SERVE_WIDTH), gen, traffic, logs,
        label, checks)
    _check_beam_launches(label, counts, steps, plain,
                         ("matmul_w8a8", "fused_norm", "gather_rows_fused",
                          "decode_attention_int8", "flash_attention"), checks)
    beam["launches_per_beam_step"] = {k: v / steps for k, v in counts.items()}
    free_card()
    greedy, counts, _, plain, greedy_streamed = _serve_traffic(
        tt, _serving_batcher(tt, gen, 1), gen, traffic, logs, "serving_generator_beam greedy",
        checks)
    check_path("serving_generator_beam greedy", counts,
               ("matmul_w8a8", "fused_norm", "decode_attention_int8", "flash_attention"),
               plain, checks)
    free_card()
    cb = _serving_batcher(tt, gen, 1, beam_size=BEAM_SERVE_WIDTH)
    gather = _gather_ms_per_step(cb, checks, "serving_generator_beam")
    cb.close()
    del cb
    free_card()
    block = dict(_profile_block(_serving_batcher(tt, side_gen, 1, beam_size=BEAM_SERVE_WIDTH),
                                lambda cb: _admit_traffic(cb, traffic),
                                "serving_generator_beam_block", SERVE_STEPS),
                 layers=SIDE_LAYERS)
    free_card()
    emit({"phase": "serving_generator_beam", "compute_type": gen.compute_type,
          "kv_cache": "int8", "slots": SERVE_SLOTS, "beam": BEAM_SERVE_WIDTH,
          "capacity": SERVE_CAPACITY, "steps_per_sync": SERVE_STEPS,
          "requests": len(traffic), "prompt_tokens": sum(len(p) for p, _ in traffic),
          "long_prompts": sum(len(p) == SERVE_LONG_PROMPT for p, _ in traffic),
          "beam_run": beam, "greedy_run_depth1": greedy, "profiled_block": block,
          "gather_per_step": gather})
    return greedy, [[t for t, _ in s] for s in greedy_streamed]


def continuous_whisper(tt, work, checks, logs):
    """Whisper-large-v3 widths at ``WHISPER_LAYERS`` + ``WHISPER_LAYERS``
    layers, int8 with the int8 KV cache, behind ``ContinuousWhisper``:
    ``CW_SEGMENTS`` segments of 3,000 frames, ``CW_SLOTS`` slots, beam
    ``CW_BEAM``, half with timestamp rules; against ``Whisper.generate``
    (beam ``CW_BEAM``) on the same segments."""
    import torch

    path = os.path.join(work, "whisper")
    with open(os.path.join(path, "vocabulary.json")) as f:
        vocab = json.load(f)
    ids, sot, _, no_ts = whisper_prompts(vocab)
    ts_begin = ids["<|notimestamps|>"] + 1
    prompts = [sot if i % 2 == 0 else no_ts for i in range(CW_SEGMENTS)]
    out = {}
    with environ(CT2TPU_KV_CACHE="int8"):
        wh = tt.Whisper(path, compute_type="int8")
        feats = whisper_features(CW_SEGMENTS, WHISPER_FRAMES, 7)
        segs = [feats[i].cpu().numpy() for i in range(CW_SEGMENTS)]
        cb = tt.ContinuousWhisper(wh, num_slots=CW_SLOTS, capacity=CW_CAPACITY,
                                  beam_size=CW_BEAM, steps_per_sync=CW_STEPS)
        consumes = _block_timer(cb)
        plain = {}
        label = "continuous_whisper"
        try:
            cb.submit(segs[0], no_ts, max_length=CW_STEPS).result(timeout=600)  # warm-up
            consumes.clear()
            steps0 = cb.num_steps
            with watched(logs, plain):
                got, seconds = synced_seconds(
                    lambda: [f.result(timeout=900) for f in [
                        cb.submit(x, p, max_length=CW_MAX_LENGTH)
                        for x, p in zip(segs, prompts)]])
                counts = tt.launch_counts()
            steps = cb.num_steps - steps0
        finally:
            cb.close()
        _check_beam_launches(label, counts, steps, plain,
                             ("matmul_w8a8", "fused_norm", "gather_rows_fused",
                              "decode_attention_int8"), checks)
        texts = [g.sequences_ids[0][len(p) - 1:] for g, p in zip(got, prompts)]
        eot = vocab.index("<|endoftext|>")
        well_formed = [timestamps_well_formed(t, ts_begin, eot)
                       for t, p in zip(texts, prompts) if p is sot]
        checks(all(well_formed) and all(math.isfinite(g.scores[0]) for g in got),
               f"{label}: finite scores; every timestamped result starts with a timestamp "
               f"and keeps the timestamp rules ({well_formed})")
        block_ms, quiet = _quiet_block_ms(consumes)
        # Whisper.generate on the same segments: its max_length covers the
        # same decode steps (it prefills the prompt, serving forces it).
        equal = {}
        for name, p in (("timestamps", sot), ("no_timestamps", no_ts)):
            idx = [i for i, q in enumerate(prompts) if q is p]
            ref = wh.generate(feats[idx], [p] * len(idx), beam_size=CW_BEAM,
                              max_length=2 * (CW_MAX_LENGTH - len(p) + 1),
                              suppress_blank=False)
            equal[name] = sum(texts[i] == r.sequences_ids[0] for i, r in zip(idx, ref))
        out = {"segments": CW_SEGMENTS, "seconds": seconds,
               "segments_per_s": CW_SEGMENTS / seconds,
               "generated_tokens": sum(len(t) for t in texts), "decode_steps": steps,
               "ms_per_block": block_ms, "blocks_timed_without_admits": quiet,
               "launches": counts, "launches_per_beam_step": {
                   k: v / steps for k, v in counts.items()},
               "equal_to_generate": equal, "segments_per_prompt": CW_SEGMENTS // 2,
               "timestamp_tokens": sum(x >= ts_begin for t in texts for x in t)}
        del cb, wh, feats
    emit({"phase": "continuous_whisper", "model": "WHISPER_LARGE_V3",
          "layers": WHISPER_LAYERS, "compute_type": "int8", "kv_cache": "int8",
          "slots": CW_SLOTS, "beam": CW_BEAM, "max_length": CW_MAX_LENGTH,
          "frames": WHISPER_FRAMES, **out})
    free_card()


def serving_beam_card_vs_cpu(tt, generators, small_dir, vocab, tvocab, checks):
    """At ``AB_LAYERS`` layers in float32: beam serving on the card against
    the CPU. The Llama pair, beam 2, 6 requests with prompts up to 513
    tokens, a stop sequence and one ``num_hypotheses=2``, with the float
    and the int8 KV cache; ``ContinuousTranslator`` beam 2 on the small
    seq2seq model with a target prefix. Tokens identical, normalized scores
    within ``LOGPROB_TOL`` (``INT8_KV_LOGPROB_TOL`` with the int8 cache)."""
    import numpy as np

    card, cpu = generators
    rng = np.random.default_rng(71)
    prompts = [[vocab.to_token(int(t)) for t in rng.integers(10, LLAMA["vocab"] - 10, n)]
               for n in BEAM_AB_PROMPTS]
    base = dict(max_length=BEAM_AB_NEW)
    best = card.generate_batch(prompts[1:2], beam_size=2, include_prompt_in_result=False,
                               **base)[0].sequences_ids[0]
    reqs = [(p, dict(base)) for p in prompts]
    reqs[1] = (prompts[1], dict(base, stop_sequences=[best[2:4]]))
    reqs[2] = (prompts[2], dict(base, num_hypotheses=2))
    out = {}
    t0 = time.perf_counter()
    for kv in ("", "int8"):
        side = {}
        for name, gen in (("card", card), ("cpu", cpu)):
            with environ(CT2TPU_KV_CACHE=kv):
                cb = tt.ContinuousBatcher(gen, num_slots=3, capacity=640, steps_per_sync=4,
                                          beam_size=2)
            try:
                side[name] = [f.result(timeout=900) for f in [cb.submit(p, **o)
                                                              for p, o in reqs]]
            finally:
                cb.close()
        tol = INT8_KV_LOGPROB_TOL if kv else LOGPROB_TOL
        same = [c.sequences_ids == p.sequences_ids for c, p in zip(side["card"], side["cpu"])]
        diff = max(abs(a - b) for c, p in zip(side["card"], side["cpu"])
                   for a, b in zip(c.scores, p.scores))
        label = f"beam serving card vs CPU ({'int8' if kv else 'float'} KV)"
        checks(all(same), f"{label}: the tokens equal on every request ({same})")
        checks(diff <= tol, f"{label}: normalized scores within {tol} (max diff {diff})")
        checks(len(side["card"][2].sequences_ids) == 2, f"{label}: two hypotheses")
        out["int8_kv" if kv else "float_kv"] = {"max_score_diff": diff, "tolerance": tol,
                                               "same_tokens": same}
    srcs = [s[:12] for s in make_batch(tvocab, 3)[:4]]
    side = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        tr = tt.Translator(small_dir, compute_type="float32", device=device)
        cb = tt.ContinuousTranslator(tr, num_slots=2, capacity=64, max_source_len=16,
                                     steps_per_sync=4, beam_size=2)
        try:
            fs = [cb.submit(s, max_length=16) for s in srcs]
            fs.append(cb.submit(srcs[0], max_length=16, target_prefix=srcs[1][:3]))
            side[name] = [f.result(timeout=600) for f in fs]
        finally:
            cb.close()
    same = [c.sequences_ids == p.sequences_ids for c, p in zip(side["card"], side["cpu"])]
    diff = max(abs(c.scores[0] - p.scores[0]) for c, p in zip(side["card"], side["cpu"]))
    checks(all(same) and diff <= LOGPROB_TOL,
           f"continuous translator card vs CPU: identical tokens, scores within "
           f"{LOGPROB_TOL} ({same}, {diff})")
    checks(side["card"][-1].sequences[0][:3] == srcs[1][:3],
           "continuous translator card vs CPU: the target prefix is forced")
    out["translator"] = {"max_score_diff": diff, "same_tokens": same}
    emit({"phase": "serving_beam_card_vs_cpu", "layers": AB_LAYERS, "compute_type": "float32",
          "requests": len(reqs), "new_tokens": BEAM_AB_NEW, **out,
          "seconds": time.perf_counter() - t0})


def continuous_whisper_card_vs_cpu(tt, work, checks):
    """``ContinuousWhisper`` beam 2 at ``AB_LAYERS`` + ``AB_LAYERS`` layers in
    float32 (``speech_card_vs_cpu``'s model) on the card against the CPU,
    with and without timestamp rules: tokens identical, scores within
    ``LOGPROB_TOL``."""
    path = os.path.join(work, "whisper_ab")
    with open(os.path.join(path, "vocabulary.json")) as f:
        vocab = json.load(f)
    _, sot, _, no_ts = whisper_prompts(vocab)
    feats = whisper_features(2, WHISPER_FRAMES, 8)
    segs = [feats[i].cpu().numpy() for i in range(2)]
    t0 = time.perf_counter()
    # The CPU batcher serves beside the card's, each on its own thread.
    batchers = {name: tt.ContinuousWhisper(
                    tt.Whisper(path, compute_type="float32", device=device), num_slots=2,
                    capacity=64, beam_size=2, steps_per_sync=4)
                for name, device in (("cpu", "cpu"), ("card", "cuda"))}
    try:
        futures = {name: [cb.submit(x, p, max_length=CW_AB_MAX_LENGTH)
                          for x in segs for p in (sot, no_ts)]
                   for name, cb in batchers.items()}
        side = {name: [f.result(timeout=900) for f in fs] for name, fs in futures.items()}
    finally:
        for cb in batchers.values():
            cb.close()
    del batchers
    same = [c.sequences_ids == p.sequences_ids for c, p in zip(side["card"], side["cpu"])]
    diff = max(abs(c.scores[0] - p.scores[0]) for c, p in zip(side["card"], side["cpu"]))
    checks(all(same) and diff <= LOGPROB_TOL,
           f"continuous whisper card vs CPU: identical tokens, scores within {LOGPROB_TOL} "
           f"({same}, {diff})")
    emit({"phase": "continuous_whisper_card_vs_cpu", "layers": AB_LAYERS,
          "compute_type": "float32", "beam": 2, "max_length": CW_AB_MAX_LENGTH,
          "same_tokens": same, "max_score_diff": diff, "seconds": time.perf_counter() - t0})
    free_card()


def serving_beam_benches(beam_logs, seen, checks):
    """The PR 17 rows (``"summed": false``): the gather at the three beam
    paths' slot-cache shapes, and the W8A8 and norm shapes of their admits
    and steps that no earlier path gave the kernels."""
    fresh = new_shapes(beam_logs, seen)
    extra = dict(summed=False, paths="PR 17: continuous_translator, "
                                     "serving_generator_beam, continuous_whisper")
    bench_gather(beam_logs.get("gather_rows_fused", {}), checks, **extra)
    free_card()
    bench_w8a8(fresh.get("matmul_w8a8", {}), checks, **extra)
    free_card()
    bench_norm(fresh.get("fused_norm", {}), checks, **extra)
    free_card()


# ---------------------------------------------------------------------------
# Lossless speculation: generate_batch(speculation_k) and the three
# batchers with prompt-lookup and draft-model drafts.
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_REQUESTS = BEAM_SERVE_REQUESTS  # serving_traffic's first 16
# meta-llama/Llama-3.2-1B config.json: 16 layers, hidden 2,048, 32 query and
# 8 KV heads of 64, intermediate 8,192, vocabulary 128,256, rope_theta
# 500,000, tied embeddings: the public draft model for Llama-3.1-8B.
LLAMA_1B = dict(layers=16, d_model=2048, heads=32, heads_kv=8, d_ff=8192,
                vocab=128256, rotary_base=500000.0)
LLAMA_1B_SEED = 100000  # the draft's weights come from seeds of their own
# The serving run's draft keeps half of the 1B's depth (its widths whole),
# a cut of the script's time on slow hosts.
LLAMA_1B_SERVE_LAYERS = LLAMA_1B["layers"] // 2
SPEC_PARTED_LOGGED = 16
SPEC_AB_NEW = 8
# generate_batch's card-against-CPU prompts: 6 up to CPU_PROMPT tokens, in
# calls of equal lengths (no prompt token is forced through the loop).
SPEC_AB_GROUPS = ((CPU_PROMPT,), (200, 200), (33, 33, 33))
SPEC_TOP = 4  # the reference's best tokens recorded a pick


@contextlib.contextmanager
def verify_route():
    """Plain greedy's one-token steps on the attention route of a verify
    (``SPEC_K`` tokens a row), so that both compute the same arithmetic:
    the int8 KV cache dequantized whole for the masked attention
    (``CT2TPU_DECODE_KERNEL=0``: a step takes the decode kernel), a
    float16 cache written first and then read whole by the masked
    attention (``CT2TPU_DECODE_CHUNK=0``, and ``decode_step_attention``,
    which reads the pre-append cache and the fresh token apart, rerouted to
    it). Speculation on the card is held to plain greedy under this route,
    where the two may part only at ties."""
    import ctranslate2_tpu_torch.models.transformer as T
    import ctranslate2_tpu_torch.ops.attention as A

    def wrap(orig):
        def step(q, k_pre, v_pre, k_new, v_new, pos, *, queries_scale=1.0, bias=None,
                 alibi_bias=None):
            T._cache_write(k_pre, k_new, pos)
            T._cache_write(v_pre, v_new, pos)
            return A.dot_product_attention(q, k_pre, v_pre,
                                           bias=A.combine_bias(bias, alibi_bias),
                                           queries_scale=queries_scale)
        return step

    with environ(CT2TPU_DECODE_KERNEL="0", CT2TPU_DECODE_CHUNK="0"), \
            patched(A, "decode_step_attention", wrap):
        yield


@contextlib.contextmanager
def recorded_picks(module, out, cb=None):
    """Records every greedy pick (``module.greedy_tokens``: a plain step's,
    an admit's, or a verify's) into ``out``: the picked ids and log-probs
    and the ``SPEC_TOP`` best log-probs and their ids, left on the card;
    for a batcher ``cb`` the request of each row (on a one-row call, the
    request being admitted). Only untimed reference runs are recorded."""
    import torch

    def wrap(orig):
        def wrapped(log_probs):
            ids, scores = orig(log_probs)
            top = torch.topk(log_probs, SPEC_TOP, dim=-1)
            rec = {"ids": ids, "scores": scores, "top_v": top.values,
                   "top_i": top.indices}
            if cb is not None:
                rec["owners"] = (cb._admitting[:1] if log_probs.shape[0] == 1
                                 else list(cb._slots))
            out.append(rec)
            return ids, scores
        return wrapped

    with patched(module, "greedy_tokens", wrap):
        yield out


def _host(rec, name):
    return rec[name].cpu().tolist()


def batcher_series(picks, futures):
    """Per request (by its future, in ``futures``' order), its picks' best
    (log-probs, ids) in emission order: the admit's, then its slot's in
    each later step (a step past the request's end is never read)."""
    index = {id(f): i for i, f in enumerate(futures)}
    out = [[] for _ in futures]
    for rec in picks:
        vals, idxs = _host(rec, "top_v"), _host(rec, "top_i")
        for s, req in enumerate(rec["owners"]):
            if req is not None and id(req.future) in index:
                out[index[id(req.future)]].append((vals[s], idxs[s]))
    return out


def loop_streams(picks, rows, eos):
    """A device loop's records (one [rows] pick a step): per row, its
    tokens up to and with the end token and each step's best (log-probs,
    ids)."""
    toks, series = [[] for _ in range(rows)], [[] for _ in range(rows)]
    ended = [False] * rows
    for rec in picks:
        ids, vals, idxs = (_host(rec, n) for n in ("ids", "top_v", "top_i"))
        for i in range(rows):
            if ended[i]:
                continue
            toks[i].append(ids[i])
            series[i].append((vals[i], idxs[i]))
            ended[i] = ids[i] == eos
    return toks, series


def _parted_at(a, b, eos):
    """The first index where token lists ``a`` and ``b`` differ, and the two
    tokens there (the end token where one list ended), or None."""
    for t in range(max(len(a), len(b))):
        x = a[t] if t < len(a) else eos
        y = b[t] if t < len(b) else eos
        if x != y:
            return t, x, y
    return None


def judge_partings(spec, plain, series, tol, eos, label, checks):
    """Holds every row's first parting from plain greedy (``plain``, its
    picks' best log-probs and ids in ``series``) to a near-tie: there the
    plain path's log-prob of the speculative token is below ``tol`` under
    its best (so its two best log-probs' gap is too). Returns the report."""
    parted = []
    for i, (a, b) in enumerate(zip(spec, plain)):
        where = _parted_at(a, b, eos)
        if where is None:
            continue
        t, x, y = where
        vals, idxs = series[i][t] if t < len(series[i]) else ([], [])
        parted.append({"row": i, "step": t, "speculative": x, "plain": y,
                       "plain_top2_gap": vals[0] - vals[1] if len(vals) > 1 else None,
                       "gap_to_speculative": vals[0] - vals[idxs.index(x)] if x in idxs
                       else None})
    gaps = [p["gap_to_speculative"] for p in parted]
    checks(all(g is not None and g < tol for g in gaps),
           f"{label}: every parting from plain greedy on the verify's attention route is "
           f"at a near-tie (the speculative token below {tol} under the best): {gaps}")
    return {"rows": len(spec), "rows_parted": len(parted), "tolerance": tol,
            "parted": parted[:SPEC_PARTED_LOGGED]}


def default_route(spec, plain, eos):
    """Where each row parts from plain greedy on a step's own attention
    route (the decode kernel, or the chunked or split read of a float16
    cache): reported, not judged (PERF.md section 5)."""
    steps = [(_parted_at(a, b, eos) or (None,))[0] for a, b in zip(spec, plain)]
    return {"rows_equal": steps.count(None), "parting_steps": steps}


@contextlib.contextmanager
def counted_verifies(out):
    """Counts in ``out[0]`` the decoder calls of T = ``SPEC_K`` tokens a row
    (``generate_batch``'s verify forwards)."""
    import ctranslate2_tpu_torch.models.transformer as T

    def wrap(orig):
        def wrapped(arch, params, consts, ids, *args, **kwargs):
            if getattr(ids, "ndim", 0) == 2 and ids.shape[1] == SPEC_K:
                out[0] += 1
            return orig(arch, params, consts, ids, *args, **kwargs)
        return wrapped

    with patched(T, "decoder_forward", wrap):
        yield out


def cut_decoder_layers(src, dst, keep):
    """A copy of the model directory ``src`` in ``dst`` whose decoder keeps
    only the layers ``keep``, renumbered from 0 (an early-exit draft: the
    encoder, embeddings, projection and vocabularies are the source's)."""
    from ctranslate2_tpu_torch.formats.model_file import load_model_file

    shutil.copytree(src, dst)
    mf = load_model_file(src)
    for name in list(mf.variables):
        m = re.match(r"decoder/layer_(\d+)/(.*)", name)
        if m is None:
            continue
        var = mf.variables.pop(name)
        if int(m.group(1)) in keep:
            var.name = f"decoder/layer_{keep.index(int(m.group(1)))}/{m.group(2)}"
            mf.variables[var.name] = var
    mf.save(dst)
    return dst


def speculation_generator(tt, gen, vocab, checks, logs, plain):
    """``generate_batch(speculation_k=4)`` on the main path's 4 prompts of
    2,049 tokens, 64 new tokens, with the int8 and the float16 KV cache,
    against the main path's plain greedy calls on the same prompts (their
    times and tokens in ``plain``, from ``generator_main_path``): every
    launch counted, the verify dispatches counted, one profiled call (int8
    KV), and each row held to plain greedy on the verify's attention route
    (``verify_route``, an untimed call with its picks recorded) up to
    near-ties."""
    import torch
    import ctranslate2_tpu_torch.decoding.device_loop as DL

    prompts = make_prompts(vocab, GEN_PROMPT, 1)  # the main path's timed call
    eos = vocab.eos_id
    t0 = time.perf_counter()
    out = {}
    for kv, tol in (("int8", INT8_KV_LOGPROB_TOL), ("", LOGPROB_TOL)):
        name = "int8_kv" if kv else "float16_kv"
        label = f"speculation_generator {name}"
        plain_s, plain_pre, plain_ids = plain[kv or "float16"]
        with environ(CT2TPU_KV_CACHE=kv):
            verifies, pl = [0], {}
            with watched(logs, pl), counted_verifies(verifies):
                spec, seconds, prefill = generate_run(gen, prompts, speculation_k=SPEC_K)
                torch.cuda.synchronize()
                counts = tt.launch_counts()
            profiled = {}
            if kv:
                for new in (PROFILE_NEW, 1):
                    n = [0]
                    with counted_verifies(n):
                        profiled[new] = (profile_call(
                            lambda: generate_run(gen, prompts, new, speculation_k=SPEC_K),
                            f"speculation_generator_{name}_{new}"), n[0])
            picks = []
            with verify_route(), recorded_picks(DL, picks):
                witness = generate_run(gen, prompts)[0]
        check_path(label, counts, ("matmul_w8a8", "flash_attention", "fused_norm"), pl,
                   checks)
        checks(counts["decode_attention_int8"] == 0 and counts["gather_rows_fused"] == 0,
               f"{label}: the verify (T = {SPEC_K}) launches no decode or gather kernel "
               f"({counts['decode_attention_int8']}, {counts['gather_rows_fused']})")
        ids = [r.sequences_ids[0] for r in spec]
        checks(all(len(x) == GEN_NEW for x in ids)
               and all(math.isfinite(r.scores[0]) for r in spec),
               f"{label}: {GEN_NEW} tokens a row, finite scores")
        w_ids = [r.sequences_ids[0] for r in witness]
        w_toks, series = loop_streams(picks, GEN_BATCH, eos)
        checks(w_toks == w_ids, f"{label}: the recorded picks replay the reference's tokens")
        del picks
        dispatches = verifies[0]
        line = {
            "ms_per_call": seconds * 1e3, "prefill_ms": prefill * 1e3,
            "verify_dispatches": dispatches,
            "tokens_per_row_per_dispatch": GEN_NEW / dispatches,
            "ms_per_dispatch": (seconds - prefill) / dispatches * 1e3,
            "launches": counts, "plain_calls_on_card": pl,
            "partings": judge_partings(ids, w_ids, series, tol, eos, label, checks),
            "rows_equal_to_plain_on_verify_route": sum(a == b for a, b in zip(ids, w_ids)),
            "max_score_diff_to_plain_on_verify_route": max(
                abs(a.scores[0] - b.scores[0]) for a, b in zip(spec, witness)),
            "plain_default_route": default_route(ids, plain_ids, eos),
            "plain_greedy": {"ms_per_call": plain_s * 1e3, "prefill_ms": plain_pre * 1e3,
                             "decode_ms_per_step": (plain_s - plain_pre) / GEN_NEW * 1e3}}
        if profiled:
            (whole, n_whole), (first, n_first) = profiled[PROFILE_NEW], profiled[1]
            line.update(
                launches_per_dispatch=((whole["kernel_launches_profiled"]
                                        - first["kernel_launches_profiled"])
                                       / max(n_whole - n_first, 1)),
                device_busy_share_profiled=whole["device_busy_share"],
                profiled_new_tokens=PROFILE_NEW, profiled_dispatches=n_whole)
        out[name] = line
        free_card()
    emit({"phase": "speculation_generator", "speculation_k": SPEC_K,
          "compute_type": gen.compute_type, "layers": len(gen.model.arch.decoder.layers),
          "prompts": GEN_BATCH, "prompt_tokens": GEN_PROMPT, "new_tokens": GEN_NEW, **out,
          "seconds": time.perf_counter() - t0})


def _spec_dispatch_profile(cb, traffic, label):
    """One verify dispatch of a stopped batcher, profiled alone after
    admitting ``SERVE_SLOTS`` requests, and four more timed with the draft
    function synced on either side: its share of a dispatch."""
    import torch

    block = _profile_block(cb, lambda cb: _admit_traffic(cb, traffic), label, 1)
    active = list(range(SERVE_SLOTS))
    if cb._draft_model is None:
        return block
    draft, spent = cb._draft_fn, [0.0]

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = draft(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - start
        return out

    cb._draft_fn = timed
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(4):
        cb._consume_any(cb._dispatch_any(active))
    total = time.perf_counter() - start
    cb._draft_fn = draft
    return dict(block, synced_dispatch_ms=total / 4 * 1e3, draft_ms=spent[0] / 4 * 1e3,
                draft_share=spent[0] / total)


def serving_generator_spec(tt, gen, vocab, checks, logs, greedy):
    """The int8 Llama with the int8 KV cache behind
    ``ContinuousBatcher(speculation_k=4)`` (``SERVE_SLOTS`` slots of
    ``SERVE_CAPACITY``): the first ``SPEC_REQUESTS`` requests of
    ``serving_traffic`` submitted at once, drafted by prompt lookup and by a
    Llama-3.2-1B-geometry draft at half its depth (``LLAMA_1B_SERVE_LAYERS``;
    int8 weights and KV cache, its own seeds);
    each against ``greedy`` (serving_generator_beam's greedy depth-1 run of
    the same requests: its line and tokens) and held to the greedy batcher
    on the verify's attention route (``verify_route``, an untimed run with
    its picks recorded) up to near-ties."""
    traffic = serving_traffic(LLAMA["vocab"])[:SPEC_REQUESTS]
    g_line, g_tokens = greedy
    eos = vocab.eos_id
    t0 = time.perf_counter()
    picks = []
    with verify_route():
        ref = _batcher_run(tt, _serving_batcher(tt, gen, 1),
                           [(([vocab.to_token(t) for t in p],), dict(max_length=new))
                            for p, new in traffic], {}, picks, warm_up=False)
    witness, series = [[t for t, _ in s] for s in ref["streamed"]], ref["series"]
    checks(ref["counts"]["decode_attention_int8"] == 0 and not ref["plain"],
           f"serving_generator_spec: the reference runs no decode kernel and no plain "
           f"version ({ref['counts']['decode_attention_int8']}, {ref['plain']})")
    del picks
    free_card()
    t1 = time.perf_counter()
    with environ(CT2TPU_KV_CACHE="int8"):
        draft = make_generator(tt, build_llama_modelfile(
            LLAMA_1B_SERVE_LAYERS, LLAMA_1B, LLAMA_1B_SEED, tied=True), vocab,
            compute_type="int8")
    draft_seconds = time.perf_counter() - t1
    draft_layers = len(draft.model.arch.decoder.layers)
    out = {"plain_on_verify_route_seconds": ref["seconds"]}
    for name, kw in (("prompt_lookup", {}), ("draft_llama_3_2_1b", dict(draft_model=draft))):
        label = f"serving_generator_spec {name}"
        cb = _serving_batcher(tt, gen, 1, speculation_k=SPEC_K, **kw)
        line, counts, steps, pl, streamed = _serve_traffic(
            tt, cb, gen, traffic, logs, label, checks,
            decode_per_step=SPEC_K * draft_layers if kw else 0)
        check_path(label, counts, ("matmul_w8a8", "fused_norm", "flash_attention")
                   + (("decode_attention_int8",) if kw else ()), pl, checks)
        checks(counts["gather_rows_fused"] == 0, f"{label}: no gather launch")
        spec = [[t for t, _ in s] for s in streamed]
        line["partings"] = judge_partings(spec, witness, series, INT8_KV_LOGPROB_TOL, eos,
                                          label, checks)
        line["requests_equal_to_plain_on_verify_route"] = sum(
            a == b for a, b in zip(spec, witness))
        line["plain_default_route"] = default_route(spec, g_tokens, eos)
        line["launches_per_dispatch_counted"] = {k: v / steps for k, v in counts.items()}
        free_card()
        line["profiled_dispatch"] = _spec_dispatch_profile(
            cb, traffic, f"serving_generator_spec_{name}_dispatch")
        del cb
        free_card()
        out[name] = line
    emit({"phase": "serving_generator_spec", "speculation_k": SPEC_K,
          "compute_type": gen.compute_type, "kv_cache": "int8", "slots": SERVE_SLOTS,
          "capacity": SERVE_CAPACITY, "requests": len(traffic),
          "draft": dict(LLAMA_1B, layers=LLAMA_1B_SERVE_LAYERS, compute_type="int8",
                        kv_cache="int8", seed=LLAMA_1B_SEED, tied_embeddings=True,
                        fabricate_seconds=draft_seconds),
          **out, "greedy_depth1": {k: g_line[k] for k in (
              "seconds", "tokens_per_s", "time_to_first_token", "request_latency",
              "decode_steps", "ms_per_block")},
          "seconds": time.perf_counter() - t0})
    del draft


def _batcher_run(tt, cb, submits, logs, picks=None, warm_up=True):
    """``submits`` (a list of (args, kwargs)) into the batcher ``cb`` at
    once, after a warm-up of the first unless ``warm_up`` is False, with
    each request's (token, score) streamed; every greedy pick recorded into
    ``picks`` when given. Returns the results, seconds, launch counts,
    plain calls on the card, dispatches, tokens a speculative dispatch,
    streams and per-request pick series (``batcher_series``)."""
    import ctranslate2_tpu_torch.runtime.continuous as C

    streamed = [[] for _ in submits]

    def on_token(i):
        def record(sr):
            streamed[i].append((sr.token_id, sr.score))
            return False
        return record

    plain = {}
    try:
        if warm_up:
            args, kw = submits[0]
            cb.submit(*args, **dict(kw, max_length=CT_STEPS, min_length=0)).result(
                timeout=600)
        steps0 = cb.num_steps
        acc0 = (cb._accepted_tokens, cb._spec_dispatches)
        with watched(logs, plain), contextlib.ExitStack() as stack:
            if picks is not None:
                stack.enter_context(recorded_picks(C, picks, cb))
            futures = []

            def run():
                futures.extend(cb.submit(*a, callback=on_token(i), **k)
                               for i, (a, k) in enumerate(submits))
                return [f.result(timeout=900) for f in futures]

            got, seconds = synced_seconds(run)
            counts = tt.launch_counts()
        steps = cb.num_steps - steps0
        per = ((cb._accepted_tokens - acc0[0]) / max(cb._spec_dispatches - acc0[1], 1)
               if cb._spec_k > 1 else None)
    finally:
        cb.close()
    return {"results": got, "seconds": seconds, "counts": counts, "plain": plain,
            "steps": steps, "per": per, "streamed": streamed,
            "series": None if picks is None else batcher_series(picks, futures)}


def continuous_translator_spec(tt, model_dir, batches, work, checks, logs, greedy):
    """The int8 Transformer-base behind ``ContinuousTranslator(speculation_k=4)``
    (``CT_SLOTS`` slots, ``max_source_len`` ``CT_SOURCE``): the 256 phase-2
    sentences, exactly ``MAX_DEC`` target tokens, with prompt lookup and
    with a draft cut from the target's own file (its encoder, embeddings
    and decoder layer 0: self-speculation by early exit); against
    ``greedy`` (continuous_translator's greedy run of the same sentences,
    held here to ``translate_batch(beam_size=1)``) and held to the greedy
    batcher on the verify's attention route (``verify_route``, an untimed
    run with its picks recorded) up to near-ties."""
    g_line, g_hyps = greedy
    tr = tt.Translator(model_dir, compute_type="int8")
    sents = [s for b in batches[:4] for s in b]
    draft_dir = cut_decoder_layers(model_dir, os.path.join(work, "int8_layer0"), [0])
    kw = dict(max_length=MAX_DEC, min_length=MAX_DEC)
    submits = [((s,), kw) for s in sents]
    ref, ref_s = synced_seconds(lambda: tr.translate_batch(
        sents, max_batch_size=BATCH, beam_size=1, max_decoding_length=MAX_DEC,
        min_decoding_length=MAX_DEC))
    ref_hyps = [r.hypotheses[0] for r in ref]
    same = sum(h == r for h, r in zip(g_hyps, ref_hyps))
    checks(same == len(sents), f"continuous_translator_spec: every greedy batcher hypothesis "
                               f"equal to translate_batch(beam_size=1)'s ({same})")
    eos = tr.model.target_vocabulary.eos_id
    picks = []
    with verify_route():
        witness = _batcher_run(tt, tt.ContinuousTranslator(
            tr, num_slots=CT_SLOTS, capacity=CT_CAPACITY, max_source_len=CT_SOURCE,
            steps_per_sync=CT_STEPS), submits, {}, picks, warm_up=False)
    w_toks = [[t for t, _ in s] for s in witness["streamed"]]
    del picks
    out = {"translate_batch_beam1": {"seconds": ref_s, "target_tokens_per_s":
                                     sum(len(h) for h in ref_hyps) / ref_s},
           "greedy": {k: g_line[k] for k in ("seconds", "target_tokens_per_s", "decode_steps")},
           "plain_on_verify_route_seconds": witness["seconds"]}
    for name, spec in (("prompt_lookup", dict(speculation_k=SPEC_K)),
                       ("draft_decoder_layer0", dict(speculation_k=SPEC_K,
                                                     draft_model=draft_dir))):
        label = f"continuous_translator_spec {name}"
        cb = tt.ContinuousTranslator(tr, num_slots=CT_SLOTS, capacity=CT_CAPACITY,
                                     max_source_len=CT_SOURCE, steps_per_sync=CT_STEPS, **spec)
        run = _batcher_run(tt, cb, submits, logs)
        counts = run["counts"]
        check_path(label, counts, ("matmul_w8a8", "fused_norm"), run["plain"], checks)
        checks(counts["decode_attention_int8"] == 0 and counts["gather_rows_fused"] == 0,
               f"{label}: no decode or gather launch (a float16 KV cache)")
        hyps = [g.sequences[0] for g in run["results"]]
        checks(all(len(h) == MAX_DEC for h in hyps)
               and all(math.isfinite(g.scores[0]) for g in run["results"]),
               f"{label}: {MAX_DEC} target tokens a sentence, finite scores")
        toks = [[t for t, _ in s] for s in run["streamed"]]
        out[name] = {
            "seconds": run["seconds"],
            "target_tokens_per_s": sum(len(h) for h in hyps) / run["seconds"],
            "dispatches": run["steps"], "launches": counts,
            "spec_tokens_per_dispatch": run["per"],
            "partings": judge_partings(toks, w_toks, witness["series"], LOGPROB_TOL, eos,
                                       label, checks),
            "equal_to_plain_on_verify_route": sum(a == b for a, b in zip(toks, w_toks)),
            "plain_default_route": default_route(hyps, g_hyps, None)}
        free_card()
    emit({"phase": "continuous_translator_spec", "compute_type": "int8",
          "speculation_k": SPEC_K, "sentences": len(sents), "slots": CT_SLOTS,
          "capacity": CT_CAPACITY, "max_source_len": CT_SOURCE, "max_length": MAX_DEC,
          **out})
    del tr


def continuous_whisper_spec(tt, work, checks, logs):
    """Whisper-large-v3 widths at ``WHISPER_LAYERS`` + ``WHISPER_LAYERS``
    layers, int8 with the int8 KV cache, behind
    ``ContinuousWhisper(speculation_k=4)`` (``CW_SLOTS`` slots,
    ``max_length`` ``CW_MAX_LENGTH``): ``CW_SEGMENTS`` segments with
    ``<|notimestamps|>`` prompts, greedy without speculation, with prompt
    lookup and with a draft of distil-large-v3's form cut from the target's
    file (its encoder and its first and last decoder layers); against
    ``Whisper.generate(beam_size=1)`` and held to the greedy batcher on the
    verify's attention route (``verify_route``, an untimed run with its
    picks recorded) up to near-ties. A timestamped request is refused
    under speculation."""
    path = os.path.join(work, "whisper")
    with open(os.path.join(path, "vocabulary.json")) as f:
        vocab = json.load(f)
    _, sot, _, no_ts = whisper_prompts(vocab)
    draft_dir = cut_decoder_layers(path, os.path.join(work, "whisper_distil"),
                                   [0, WHISPER_LAYERS - 1])
    eot = vocab.index("<|endoftext|>")
    tail = len(no_ts) - 1  # the forced prompt tail each result starts with
    out = {}
    t0 = time.perf_counter()
    with environ(CT2TPU_KV_CACHE="int8"):
        wh = tt.Whisper(path, compute_type="int8")
        feats = whisper_features(CW_SEGMENTS, WHISPER_FRAMES, 9)
        segs = [feats[i].cpu().numpy() for i in range(CW_SEGMENTS)]
        submits = [((x, no_ts), dict(max_length=CW_MAX_LENGTH)) for x in segs]
        ref, ref_s = synced_seconds(lambda: wh.generate(
            feats, [no_ts] * CW_SEGMENTS, beam_size=1,
            max_length=2 * (CW_MAX_LENGTH - len(no_ts) + 1), suppress_blank=False))
        # The serving results end at CW_MAX_LENGTH - tail generated tokens.
        generated = [r.sequences_ids[0][:CW_MAX_LENGTH - tail] for r in ref]
        out["generate_beam1"] = {"seconds": ref_s, "segments_per_s": CW_SEGMENTS / ref_s}
        picks = []
        with verify_route():
            witness = _batcher_run(tt, tt.ContinuousWhisper(
                wh, num_slots=CW_SLOTS, capacity=CW_CAPACITY, steps_per_sync=CW_STEPS),
                submits, {}, picks, warm_up=False)
        # The series has a pick for each forced prompt-tail token too, so the
        # streams are judged whole (their forced tails are equal).
        w_toks = [[t for t, _ in s] for s in witness["streamed"]]
        del picks
        out["plain_on_verify_route_seconds"] = witness["seconds"]
        for name, spec in (("greedy", {}), ("prompt_lookup", dict(speculation_k=SPEC_K)),
                           ("draft_distil_form", dict(speculation_k=SPEC_K,
                                                      draft_model=draft_dir))):
            label = f"continuous_whisper_spec {name}"
            cb = tt.ContinuousWhisper(wh, num_slots=CW_SLOTS, capacity=CW_CAPACITY,
                                      steps_per_sync=CW_STEPS, **spec)
            if spec:
                try:
                    cb.submit(segs[0], sot, max_length=8)
                    refused = False
                except NotImplementedError:
                    refused = True
                checks(refused, f"{label}: a timestamped request is refused")
            draft_layers = (len(cb._draft_model.arch.decoder.layers)
                            if "draft_model" in spec else 0)
            run = _batcher_run(tt, cb, submits, logs)
            counts, steps = run["counts"], run["steps"]
            expected = (SPEC_K * draft_layers if spec
                        else len(wh.model.arch.decoder.layers)) * steps
            check_path(label, counts, ("matmul_w8a8", "fused_norm"), run["plain"], checks)
            checks(counts["decode_attention_int8"] == expected
                   and counts["gather_rows_fused"] == 0,
                   f"{label}: {expected} decode launches ({counts['decode_attention_int8']}), "
                   f"no gather")
            checks(all(math.isfinite(g.scores[0]) for g in run["results"]),
                   f"{label}: finite scores")
            toks = [[t for t, _ in s] for s in run["streamed"]]
            texts = [g.sequences_ids[0][tail:] for g in run["results"]]
            line = {"seconds": run["seconds"], "segments_per_s": CW_SEGMENTS / run["seconds"],
                    "generated_tokens": sum(len(t) - tail for t in toks), "dispatches": steps,
                    "launches": counts, "spec_tokens_per_dispatch": run["per"],
                    "plain_default_route": default_route(texts, generated, eot)}
            if spec:
                line.update(
                    partings=judge_partings(toks, w_toks, witness["series"],
                                            INT8_KV_LOGPROB_TOL, eot, label, checks),
                    equal_to_plain_on_verify_route=sum(a == b for a, b in zip(toks, w_toks)))
            out[name] = line
            free_card()
        del wh, feats
    emit({"phase": "continuous_whisper_spec", "model": "WHISPER_LARGE_V3",
          "layers": WHISPER_LAYERS, "draft_decoder_layers": [0, WHISPER_LAYERS - 1],
          "compute_type": "int8", "kv_cache": "int8", "speculation_k": SPEC_K,
          "slots": CW_SLOTS, "max_length": CW_MAX_LENGTH, "frames": WHISPER_FRAMES,
          "segments": CW_SEGMENTS, **out, "seconds": time.perf_counter() - t0})
    free_card()


def speculation_card_vs_cpu(tt, generators, small_llama, small_dir, vocab, tvocab, checks):
    """At ``AB_LAYERS`` layers in float32, speculation on the card against
    the CPU: on the Llama pair, ``generate_batch(speculation_k=4)`` over 6
    prompts up to ``CPU_PROMPT`` tokens (``SPEC_AB_GROUPS``), and the
    batcher with a 1-layer draft cut from the pair over 6 prompts up to
    ``CPU_PROMPT`` tokens, one request with a stop sequence and one with
    ``no_repeat_ngram_size``; ``ContinuousTranslator`` on the small seq2seq
    model with a target prefix. Tokens identical, scores within
    ``LOGPROB_TOL``. On the card alone, speculation is also held to plain
    greedy on each step's own attention route, where in float32 the two
    paths' arithmetic agree: ``generate_batch`` with the float32 cache
    (a parting below ``LOGPROB_TOL``) and, with the int8 KV cache (plain
    steps on the decode kernel, the verify on the dequantized cache),
    ``generate_batch`` and the batcher's prompt lookup at per-row positions
    (a parting below ``INT8_KV_LOGPROB_TOL``)."""
    import numpy as np
    import ctranslate2_tpu_torch.decoding.device_loop as DL

    card, cpu = generators
    rng = np.random.default_rng(81)

    def draw(lengths):
        return [[vocab.to_token(int(t)) for t in rng.integers(10, LLAMA["vocab"] - 10, n)]
                for n in lengths]

    t0 = time.perf_counter()
    out = {}

    def compare(name, side):
        same = [c.sequences_ids == p.sequences_ids for c, p in zip(side["card"], side["cpu"])]
        diff = max(abs(a - b) for c, p in zip(side["card"], side["cpu"])
                   for a, b in zip(c.scores, p.scores))
        checks(all(same) and diff <= LOGPROB_TOL,
               f"speculation card vs CPU, {name}: identical tokens, scores within "
               f"{LOGPROB_TOL} ({same}, {diff})")
        out[name] = {"same_tokens": same, "max_score_diff": diff}

    def held_to_plain(prompts, kv, tol):
        """On the card: ``generate_batch`` plain (picks recorded) and
        speculative, with the KV cache ``kv``; returns the speculative
        results and the partings' report."""
        picks = []
        with environ(CT2TPU_KV_CACHE=kv):
            before = tt.launch_counts()["decode_attention_int8"]
            with recorded_picks(DL, picks):
                plain = [r.sequences_ids[0] for r in card.generate_batch(prompts, **kw)]
            stepped = tt.launch_counts()["decode_attention_int8"] - before
            spec = card.generate_batch(prompts, speculation_k=SPEC_K, **kw)
            verified = tt.launch_counts()["decode_attention_int8"] - before - stepped
        if kv:
            checks(stepped > 0 and verified == 0,
                   f"speculation card, int8 KV: plain steps launch the decode kernel "
                   f"({stepped}), the verify none ({verified})")
        _, series = loop_streams(picks, len(prompts), vocab.eos_id)
        return spec, judge_partings(
            [r.sequences_ids[0] for r in spec], plain, series, tol, vocab.eos_id,
            f"speculation card, {kv or 'float32'} KV, spec vs plain greedy "
            f"{[len(p) for p in prompts]}", checks)

    kw = dict(max_length=SPEC_AB_NEW, min_length=SPEC_AB_NEW, include_prompt_in_result=False,
              return_scores=True)
    side, judged, judged8 = {"card": [], "cpu": []}, [], []
    for lengths in SPEC_AB_GROUPS:
        prompts = draw(lengths)
        spec, report = held_to_plain(prompts, "", LOGPROB_TOL)
        side["card"] += spec
        side["cpu"] += cpu.generate_batch(prompts, speculation_k=SPEC_K, **kw)
        judged.append(report)
        judged8.append(held_to_plain(prompts, "int8", INT8_KV_LOGPROB_TOL)[1])
    compare("generate_batch", side)
    out["card_spec_vs_plain"] = judged
    out["card_int8_kv_spec_vs_plain"] = judged8
    prompts = draw(BEAM_AB_PROMPTS)
    best = card.generate_batch(prompts[1:2], max_length=SPEC_AB_NEW,
                               include_prompt_in_result=False)[0].sequences_ids[0]
    base = dict(max_length=SPEC_AB_NEW)
    reqs = [((p,), dict(base)) for p in prompts]
    # The int8 KV cache at per-row positions: the greedy batcher (the
    # decode kernel) against prompt lookup (the dequantized cache).
    with environ(CT2TPU_KV_CACHE="int8"):
        runs = [_batcher_run(tt, tt.ContinuousBatcher(card, num_slots=3, capacity=640,
                                                      steps_per_sync=4, **spec),
                             reqs, {}, picks, warm_up=False)
                for spec, picks in (({}, []), (dict(speculation_k=SPEC_K), None))]
    stepped, verified = (r["counts"]["decode_attention_int8"] for r in runs)
    checks(stepped > 0 and verified == 0,
           f"speculation card, int8 KV batcher: greedy steps launch the decode kernel "
           f"({stepped}), the verify none ({verified})")
    greedy, spec = ([[t for t, _ in s] for s in r["streamed"]] for r in runs)
    out["card_int8_kv_batcher_spec_vs_plain"] = judge_partings(
        spec, greedy, runs[0]["series"], INT8_KV_LOGPROB_TOL, vocab.eos_id,
        "speculation card, int8 KV batcher, prompt lookup vs greedy", checks)
    reqs[1] = ((prompts[1],), dict(base, stop_sequences=[best[2:4]]))
    reqs[2] = ((prompts[2],), dict(base, no_repeat_ngram_size=2))
    draft_mf = llama_subset(small_llama, 1)
    side = {}
    for name, gen, device in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        draft = make_generator(tt, draft_mf, vocab, device=device, compute_type="float32",
                               flash_attention=True)
        cb = tt.ContinuousBatcher(gen, num_slots=3, capacity=640, steps_per_sync=4,
                                  speculation_k=SPEC_K, draft_model=draft)
        try:
            side[name] = [f.result(timeout=900) for f in [cb.submit(*a, **o)
                                                          for a, o in reqs]]
        finally:
            cb.close()
        del draft
    compare("batcher_with_1_layer_draft", side)
    srcs = [s[:12] for s in make_batch(tvocab, 3)[:4]]
    side = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        tr = tt.Translator(small_dir, compute_type="float32", device=device)
        cb = tt.ContinuousTranslator(tr, num_slots=2, capacity=64, max_source_len=16,
                                     steps_per_sync=4, speculation_k=SPEC_K)
        try:
            fs = [cb.submit(s, max_length=16) for s in srcs]
            fs.append(cb.submit(srcs[0], max_length=16, target_prefix=srcs[1][:3]))
            side[name] = [f.result(timeout=600) for f in fs]
        finally:
            cb.close()
    compare("continuous_translator", side)
    checks(side["card"][-1].sequences[0][:3] == srcs[1][:3],
           "speculation card vs CPU: the translator's target prefix is forced")
    emit({"phase": "speculation_card_vs_cpu", "layers": AB_LAYERS, "compute_type": "float32",
          "speculation_k": SPEC_K, **out, "seconds": time.perf_counter() - t0})
    free_card()


def speculation_whisper_card_vs_cpu(tt, work, checks):
    """``ContinuousWhisper(speculation_k=4)`` at ``AB_LAYERS`` +
    ``AB_LAYERS`` layers in float32 (``speech_card_vs_cpu``'s model) on the
    card against the CPU, ``<|notimestamps|>`` prompts: tokens identical,
    scores within ``LOGPROB_TOL``."""
    t0 = time.perf_counter()
    path = os.path.join(work, "whisper_ab")
    with open(os.path.join(path, "vocabulary.json")) as f:
        wvocab = json.load(f)
    _, _, _, no_ts = whisper_prompts(wvocab)
    feats = whisper_features(2, WHISPER_FRAMES, 8)
    segs = [feats[i].cpu().numpy() for i in range(2)]
    side = {}
    for name, device in (("card", "cuda"), ("cpu", "cpu")):
        w = tt.Whisper(path, compute_type="float32", device=device)
        cb = tt.ContinuousWhisper(w, num_slots=2, capacity=64, steps_per_sync=4,
                                  speculation_k=SPEC_K)
        try:
            side[name] = [f.result(timeout=900) for f in [
                cb.submit(x, no_ts, max_length=CW_AB_MAX_LENGTH) for x in segs]]
        finally:
            cb.close()
        del w
    same = [c.sequences_ids == p.sequences_ids for c, p in zip(side["card"], side["cpu"])]
    diff = max(abs(c.scores[0] - p.scores[0]) for c, p in zip(side["card"], side["cpu"]))
    checks(all(same) and diff <= LOGPROB_TOL,
           f"speculation card vs CPU, continuous whisper: identical tokens, scores within "
           f"{LOGPROB_TOL} ({same}, {diff})")
    emit({"phase": "speculation_whisper_card_vs_cpu", "layers": AB_LAYERS,
          "compute_type": "float32", "speculation_k": SPEC_K, "same_tokens": same,
          "max_score_diff": diff, "seconds": time.perf_counter() - t0})
    free_card()


def speculation_benches(spec_logs, seen, checks):
    """The speculation rows (``"summed": false``), at the shapes of the
    speculation phases that no earlier path gave a kernel: W8A8 and the
    norm at the verify dispatches' M (rows x 4), flash and the decode
    kernel at head dim 64 (the 1B draft's admit and feeds)."""
    fresh = new_shapes(spec_logs, seen)
    extra = dict(summed=False, paths="speculation: speculation_generator, serving_generator_spec, "
                                     "continuous_translator_spec, continuous_whisper_spec")
    verify_m = (GEN_BATCH * SPEC_K, SERVE_SLOTS * SPEC_K, CT_SLOTS * SPEC_K,
                CW_SLOTS * SPEC_K)

    def pick(name, keep):
        return {k: n for k, n in fresh.get(name, {}).items() if keep(k)}

    bench_w8a8(pick("matmul_w8a8", lambda k: k[0] in verify_m), checks, **extra)
    free_card()
    bench_norm(pick("fused_norm", lambda k: k[0] in verify_m), checks, **extra)
    free_card()
    draft_d = LLAMA_1B["d_model"] // LLAMA_1B["heads"]
    bench_flash(pick("flash_attention", lambda k: k[0][3] == draft_d), checks, **extra)
    free_card()
    # The draft's feeds: the slots' cache lengths spread from a short
    # prompt's to a long prompt's.
    bench_decode(pick("decode_attention_int8", lambda k: k[0][3] == draft_d),
                 SERVE_SHORT_PROMPT[0], SERVE_LONG_PROMPT, checks, **extra)
    free_card()


HOST_CORE_SCHED_SENTENCES = BATCH  # translation_scheduler: one phase-2 batch
HOST_CORE_REPLICAS = [0, 0]  # two replicas on the one card


def proc_status_kb():
    """VmHWM, VmRSS, RssAnon and RssFile of this process, in kB, those that
    ``/proc/self/status`` gives (some kernels give VmRSS alone),
    and ``getrusage``'s peak resident size (``ru_maxrss``)."""
    import resource

    out = {}
    with open("/proc/self/status", encoding="ascii") as f:
        for line in f:
            key, _, value = line.partition(":")
            if key in ("VmHWM", "VmRSS", "RssAnon", "RssFile"):
                out[key] = int(value.split()[0])
    out["ru_maxrss"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return out


def host_memory_during(call):
    """(result, seconds, memory) of ``call()`` with the card synced on
    either side: the change of VmHWM, VmRSS, RssAnon and RssFile (kB) over
    the call, and the peak VmRSS above its start, sampled every 5 ms."""
    import threading

    before = proc_status_kb()
    peak = [before["VmRSS"]]
    done = threading.Event()

    def sample():
        while not done.wait(0.005):
            peak[0] = max(peak[0], proc_status_kb()["VmRSS"])

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out, seconds = synced_seconds(call)
    finally:
        done.set()
        sampler.join()
    after = proc_status_kb()
    peak[0] = max(peak[0], after["VmRSS"])
    memory = {f"{k}_delta_kb": after[k] - before[k] for k in before}
    memory["VmRSS_peak_delta_kb"] = peak[0] - before["VmRSS"]
    return out, seconds, memory


def host_core_native(checks, build_seconds, module_path):
    """The native core: built from the checkout into the port's ``_build/``
    and loaded under its package-qualified name (no JAX module in the
    process)."""
    from ctranslate2_tpu_torch import native
    from ctranslate2_tpu_torch.kernels import build

    module = native.load()
    inside = os.path.dirname(os.path.abspath(module.__file__)) == os.path.abspath(
        build.build_dir())
    checks(inside and module.__file__ == module_path,
           f"host_core: the native module lies in the port's build directory "
           f"({module.__file__})")
    checks(module.__name__ == "ctranslate2_tpu_torch.native.ct2tpu_host"
           and "ct2tpu_host" not in sys.modules and "jax" not in sys.modules,
           f"host_core: the native module is the port's own ({module.__name__})")
    emit({"phase": "host_core_native", "build_seconds": build_seconds,
          "module": os.path.relpath(module.__file__, os.getcwd()),
          "name": module.__name__})


def host_core_load(tt, llama, work, checks):
    """The int8 Llama at ``MAIN_LAYERS`` written into the work directory
    (``llama_int8``, kept for the parallel phases) and loaded to the card
    twice, through the native index over a map of
    model.bin and through the copying reader, each timed with this process's
    host memory over the load; the two parameter trees must be bit-equal on
    the card. The card is freed before the first load; the first tree stays
    on it for the comparison."""
    import torch
    from ctranslate2_tpu_torch.formats.model_file import load_model_file_copied
    from ctranslate2_tpu_torch.models.loader import load_model

    path = os.path.join(work, "llama_int8")
    _, write_s = synced_seconds(lambda: llama.save(path))
    file_bytes = os.path.getsize(os.path.join(path, "model.bin"))
    free_card()
    out = {"file_bytes": file_bytes, "write_seconds": write_s,
           "page_cache": "warm (the file was just written)"}
    mapped, seconds, memory = host_memory_during(
        lambda: load_model(path, compute_type="int8", device="cuda"))
    out["mapped"] = {"seconds": seconds, "gbytes_per_s": file_bytes / seconds / 1e9,
                     **memory}
    gc.collect()
    copied, seconds, memory = host_memory_during(
        lambda: load_model(load_model_file_copied(path), compute_type="int8",
                           device="cuda"))
    out["copied"] = {"seconds": seconds, "gbytes_per_s": file_bytes / seconds / 1e9,
                     **memory}

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in leaves(v, f"{prefix}/{k}")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in leaves(v, f"{prefix}/{i}")]
        return [(prefix, tree)] if torch.is_tensor(tree) else []

    a, b = leaves(mapped.params), leaves(copied.params)
    unequal = [name for (name, x), (_, y) in zip(a, b)
               if not (x.is_cuda and x.dtype == y.dtype and torch.equal(x, y))]
    checks(len(a) == len(b) and a and not unequal,
           f"host_core load: the mapped and copied parameter trees are bit-equal on "
           f"the card ({len(a)} and {len(b)} tensors, unequal: {unequal[:4]})")
    out["param_tensors"] = len(a)
    out["param_bytes"] = sum(x.numel() * x.element_size() for _, x in a)
    out["bit_equal"] = not unequal
    del mapped, copied, a, b
    free_card()  # the file stays for the parallel phases
    emit({"phase": "host_core_load", "config": dict(LLAMA, layers=MAIN_LAYERS), **out})


def host_core_cli(tt, model_dir, batches, work, checks, logs):
    """``cli.translate.main`` in process on the four phase-2 batches, int8,
    beam 2, exactly 32 tokens, with ``--log_throughput`` and then also
    ``--log_profiling``: its file must equal ``translate_file``'s on the same
    input, line for line; the launch counters zeroed before each run and
    read after."""
    import io
    from ctranslate2_tpu_torch.cli import translate as cli

    sents = [s for b in batches[:4] for s in b]
    src = os.path.join(work, "cli_src.txt")
    with open(src, "w", encoding="utf-8") as f:
        f.write("".join(" ".join(s) + "\n" for s in sents))
    ref_path = os.path.join(work, "cli_ref.txt")
    tr = tt.Translator(model_dir, compute_type="int8")
    opts = {k: v for k, v in OPTS.items() if k != "return_scores"}
    tr.translate_file(src, ref_path, max_batch_size=BATCH, **opts)
    with open(ref_path, encoding="utf-8") as f:
        ref = f.read().splitlines()
    del tr
    args = ["--model", model_dir, "--src", src, "--device", "cuda",
            "--compute_type", "int8", "--beam_size", str(BEAM),
            "--batch_size", str(BATCH), "--max_decoding_length", str(MAX_DEC),
            "--min_decoding_length", str(MAX_DEC), "--log_throughput"]
    out = {}
    for label, extra in (("plain", []), ("log_profiling", ["--log_profiling"])):
        path = os.path.join(work, f"cli_out_{label}.txt")
        err = io.StringIO()
        plain = {}
        with watched(logs, plain), contextlib.redirect_stderr(err):
            (rc, seconds) = synced_seconds(lambda: cli.main([*args, "--out", path, *extra]))
            counts = tt.launch_counts()
        check_path(f"host_core cli {label}", counts, ["matmul_w8a8", "fused_norm"],
                   plain, checks)
        with open(path, encoding="utf-8") as f:
            lines = f.read().splitlines()
        same = sum(a == b for a, b in zip(lines, ref))
        checks(rc == 0 and len(lines) == len(ref) == len(sents) and same == len(ref),
               f"host_core cli {label}: {same} of {len(lines)} lines equal to "
               f"translate_file's ({len(ref)})")
        text = err.getvalue().splitlines()
        tok_s = [float(line.split(": ")[1]) for line in text
                 if line.startswith("Tokens per second: ")]
        checks(len(tok_s) == 1 and tok_s[0] > 0,
               f"host_core cli {label}: --log_throughput printed tok/s ({tok_s})")
        out[label] = {"seconds_with_load": seconds, "tokens_per_s": tok_s[0] if tok_s else None,
                      "lines_equal": same, "launches": counts}
        if extra:
            rows = [line.split() for line in text if line.startswith("Translator.")]
            checks(any(r[0] == "Translator.translate_batch" and int(r[1]) == 4 for r in rows),
                   f"host_core cli: --log_profiling printed the scopes table ({rows})")
            out[label]["profile_rows"] = rows
    emit({"phase": "host_core_cli", "sentences": len(sents), **out})


def host_core_scheduler(tt, model_dir, batches, checks, logs):
    """``translation_scheduler`` on the native queue: one phase-2 batch
    submitted a sentence at a time. Each batch the scheduler formed must
    give what ``translate_batch`` gives on that batch, and each request its
    row's result; the share equal to one ``translate_batch`` of all 64 is
    recorded."""
    from ctranslate2_tpu_torch import native

    tr = tt.Translator(model_dir, compute_type="int8")
    sents = batches[1][:HOST_CORE_SCHED_SENTENCES]
    whole = tr.translate_batch(sents, **OPTS)

    class Recorder:
        def __init__(self):
            self.calls = []

        def translate_batch(self, examples, prefixes=None, **options):
            results = tr.translate_batch(examples, prefixes, **options)
            self.calls.append((list(examples), results))
            return results

    rec = Recorder()
    sched = tt.translation_scheduler(rec, max_batch_size=BATCH, batch_timeout_ms=20.0)
    plain = {}
    try:
        checks(type(sched._queue) is native.RequestQueue,
               f"host_core scheduler: the queue is the native RequestQueue "
               f"({type(sched._queue)})")
        with watched(logs, plain):
            futures, seconds = synced_seconds(
                lambda: [f.result() for f in [sched.submit(s, **OPTS) for s in sents]])
            counts = tt.launch_counts()
    finally:
        sched.close()
    check_path("host_core scheduler", counts, ["matmul_w8a8", "fused_norm"], plain, checks)
    rows = {}
    for examples, results in rec.calls:
        for ex, r in zip(examples, results):
            rows.setdefault(tuple(ex), []).append(r.hypotheses)
    again = [tr.translate_batch(examples, **OPTS) for examples, _ in rec.calls]
    same_batch = all([r.hypotheses for r in a] == [r.hypotheses for r in res]
                     for a, (_, res) in zip(again, rec.calls))
    routed = all(f.hypotheses in rows.get(tuple(s), []) for f, s in zip(futures, sents))
    same_whole = sum(f.hypotheses == w.hypotheses for f, w in zip(futures, whole))
    checks(same_batch and routed and sum(len(e) for e, _ in rec.calls) == len(sents),
           f"host_core scheduler: each batch equal to translate_batch on it "
           f"({same_batch}), each request its row's result ({routed})")
    emit({"phase": "host_core_scheduler", "requests": len(sents),
          "batches": [len(e) for e, _ in rec.calls], "seconds": seconds,
          "equal_to_one_translate_batch": same_whole, "launches": counts})
    del tr


def union_ms(intervals):
    """The length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def host_core_replicas(tt, model_dir, batches, checks, logs):
    """``Translator(device_index=[0, 0])`` on ``model_dir`` (the int8
    Transformer-base at ``HALF_LAYERS`` + ``HALF_LAYERS`` layers, for the
    run's time limit): two replicas on the card, one
    CUDA stream each, the four phase-2 batches submitted at once; every
    hypothesis must equal the one-replica Translator's on the same batches.
    Target tok/s of one replica, of one replica with two workers (two
    threads, one stream) and of two replicas; two batches of the
    two-replica run profiled (busy share over the union of kernel
    intervals, and over their sum), the
    launch counters and shape logs over the run; then ``unload_model(
    to_cpu=True)`` / ``load_model()`` must free and restore the one shared
    tree. Last, the same batches through an ``Encoder`` of two replicas:
    the card tensors its jobs return, read on this thread's stream, must
    equal one replica's bit for bit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sents = batches[:4]

    def run(tr, batches=sents):
        futures = [tr.translate_batch(b, asynchronous=True, **OPTS) for b in batches]
        return [[r.result() for r in f] for f in futures]

    def tokens(results):
        return sum(len(r.hypotheses[0]) for res in results for r in res)

    one = tt.Translator(model_dir, compute_type="int8")
    run(one)  # warm-up
    ref, one_s = synced_seconds(lambda: run(one))
    del one
    # Two workers on one replica (the default stream): what two threads
    # cost without a second stream.
    threads = tt.Translator(model_dir, compute_type="int8", inter_threads=2)
    run(threads, sents[:2])  # warm-up, a batch a worker
    two_workers, threads_s = synced_seconds(lambda: run(threads))
    del threads
    free_card()
    two = tt.Translator(model_dir, device="cuda", device_index=HOST_CORE_REPLICAS,
                        compute_type="int8")
    m0, m1 = two._all_models()
    streams = two._replica_streams
    checks(two.num_replicas == 2 and two.num_workers == 2 and m0.params is m1.params
           and len(streams) == 2 and streams[0] != streams[1],
           "host_core replicas: two replicas sharing one tree, a stream each")
    job_streams = {two._pool.submit(lambda: torch.cuda.current_stream().cuda_stream)
                   .result() for _ in range(8)}
    checks(job_streams <= {s.cuda_stream for s in streams},
           f"host_core replicas: jobs run on the replicas' streams ({job_streams})")
    run(two, sents[:2])  # warm-up, a batch a replica: each stream's workspaces
    plain, before = {}, {k: sum(v.values()) for k, v in logs.items()}
    with watched(logs, plain):
        out, two_s = synced_seconds(lambda: run(two))
        counts = tt.launch_counts()
    check_path("host_core replicas", counts, ["matmul_w8a8", "fused_norm"], plain, checks)
    check_logs_cover(counts, logs, before, "host_core replicas", checks)
    same = sum(a.hypotheses == b.hypotheses for x, y in zip(out, ref) for a, b in zip(x, y))
    total = sum(len(b) for b in sents)
    checks(same == total, f"host_core replicas: {same} of {total} hypotheses equal to "
                          "the one-replica Translator's")
    # The device's busy share over two batches, one a replica (kernels
    # only: the host's ops would multiply the profiler's work).
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        futures = [two.translate_batch(b, asynchronous=True, **OPTS) for b in sents[:2]]
        [[r.result() for r in f] for f in futures]
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_union = union_ms([(e.time_range.start / 1e3, e.time_range.end / 1e3)
                           for e in kernels])
    busy_sum = sum(e.time_range.elapsed_us() for e in kernels) / 1e3

    # Residency over both replicas: one shared tree out and back.
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree] if torch.is_tensor(tree) else []

    param_bytes = sum(t.numel() * t.element_size() for t in leaves(m0.params))
    torch.cuda.synchronize()
    loaded = torch.cuda.memory_allocated()
    _, unload_s = synced_seconds(lambda: two.unload_model(to_cpu=True))
    unloaded = torch.cuda.memory_allocated()
    dropped = m0.params is None and m1.params is None
    _, load_s = synced_seconds(two.load_model)
    reloaded = torch.cuda.memory_allocated()
    checks(dropped and loaded - unloaded >= param_bytes and
           param_bytes <= reloaded - unloaded < 1.5 * param_bytes and
           two._all_models()[0].params is two._all_models()[1].params,
           f"host_core replicas: the one shared tree freed ({loaded - unloaded} bytes) and "
           f"restored once ({reloaded - unloaded} of {param_bytes} bytes)")
    again = run(two, sents[:2])
    checks([[r.hypotheses for r in x] for x in again]
           == [[r.hypotheses for r in x] for x in out[:2]],
           "host_core replicas: the same hypotheses after the reload")
    num_replicas = two.num_replicas
    del two, m0, m1
    free_card()
    # Card tensors that a job makes on a replica's stream and the caller
    # reads on its own: the Translator's encoder, asynchronous batches
    # through both replicas, bit-equal to one replica's.
    enc = tt.Encoder(model_dir, compute_type="int8")
    enc_ref = [enc.forward_batch(b).last_hidden_state for b in sents]
    del enc
    encs = tt.Encoder(model_dir, device="cuda", device_index=HOST_CORE_REPLICAS,
                      compute_type="int8")
    pending = [encs.forward_batch_async(b) for b in sents]
    enc_equal = sum(torch.equal(p.result().last_hidden_state, r)
                    for p, r in zip(pending, enc_ref))
    checks(encs.num_replicas == 2 and enc_equal == len(sents),
           f"host_core replicas: {enc_equal} of {len(sents)} Encoder batches through two "
           "replicas bit-equal to one replica's")
    del encs, pending, enc_ref
    emit({"phase": "host_core_replicas", "num_replicas": num_replicas,
          "device_index": HOST_CORE_REPLICAS, "sentences": total,
          "one_replica": {"seconds": one_s, "target_tokens_per_s": tokens(ref) / one_s},
          "one_replica_two_workers": {"seconds": threads_s,
                                      "target_tokens_per_s": tokens(two_workers) / threads_s},
          "two_replicas": {"seconds": two_s, "target_tokens_per_s": tokens(out) / two_s},
          "hypotheses_equal": same, "encoder_batches_equal": enc_equal,
          "launches": counts,
          "profiled": {"batches": 2, "wall_ms": wall_ms, "device_busy_union_ms": busy_union,
                       "device_busy_share": busy_union / wall_ms,
                       "kernel_ms_summed": busy_sum,
                       "kernel_launches": len(kernels)},
          "residency": {"param_bytes": param_bytes, "freed_bytes": loaded - unloaded,
                        "restored_bytes": reloaded - unloaded,
                        "unload_seconds": unload_s, "load_seconds": load_s}})


# ---------------------------------------------------------------------------
# Tensor parallelism: one in-process NCCL rank, then two ranks on the one
# card over gloo (children of this script started through
# ``parallel/launch.py``).
# ---------------------------------------------------------------------------

# The parallel phases' Llama calls: the first-step check on PAR_ROWS prompts
# of PAR_SHORT (their int8 activations travel to the ranks through a file),
# the timed greedy call on PAR_ROWS prompts of GEN_PROMPT (the flash
# kernel's prefill) with PAR_NEW new tokens, beam 2 on one PAR_SHORT prompt,
# and PAR_SERVE requests of PAR_SERVE_PROMPT tokens through the batcher.
PAR_ROWS = 2
PAR_SHORT = 257
PAR_NEW = 16
PAR_SERVE = 4
PAR_SERVE_PROMPT = 64
PAR_SENTENCES = 16  # of a phase-2 batch, for the Translator runs
# The ring prefill: one prompt whose prefill is the ring's threshold, 4,096
# tokens, over a data axis of 2 (two sequence slices of 2,048).
PAR_RING_PROMPT = 4097
PAR_TIMEOUT = 600  # seconds for the two ranks' job
PAR_PROBE_TIMEOUT = 60  # seconds for the two-rank NCCL probe


def par_prompts(vocab):
    """(short prompts, long prompts, serving prompts, the ring's prompt)."""
    short = make_prompts(vocab, PAR_SHORT, 11)[:PAR_ROWS]
    long = make_prompts(vocab, GEN_PROMPT, 12)[:PAR_ROWS]
    serve = [p[:PAR_SERVE_PROMPT - 3 * i] for i, p in
             enumerate(make_prompts(vocab, PAR_SERVE_PROMPT, 13) * 2)][:PAR_SERVE]
    ring = make_prompts(vocab, PAR_RING_PROMPT, 14)[:1]
    return short, long, serve, ring


def param_bytes(params):
    import torch

    def walk(t):
        if isinstance(t, dict):
            return sum(walk(v) for v in t.values())
        if isinstance(t, (list, tuple)):
            return sum(walk(v) for v in t)
        return t.numel() * t.element_size() if torch.is_tensor(t) else 0
    return walk(params)


def par_llama_runs(tt, path, vocab, prompts, fed=None):
    """The int8 Llama's runs (int8 KV cache) that one rank and two compare:
    the first step's log-probs on the short prompts (recording the int8
    activations, or fed ``fed``'s), the timed greedy call on the long
    prompts with the profiler's time in collectives, beam 2 and the
    batcher. Returns (results, shape logs, launch counts, plain calls)."""
    import torch
    from ctranslate2_tpu_torch.utils import profiler as P

    short, long, serve, _ = prompts
    out, logs, plain = {}, {}, {}
    with environ(CT2TPU_KV_CACHE="int8"):
        gen = make_generator(tt, path, vocab, compute_type="int8",
                             tensor_parallel=fed is not None)
        out["param_bytes"] = param_bytes(gen.model.params)
        out["memory_allocated_after_load"] = torch.cuda.memory_allocated()
        if fed is None:
            recorded = []
            out["logp"] = generator_first_step_logprobs(gen, short, record_quantized(recorded))
            out["recorded"] = [(q.cpu(), s.cpu()) for q, s in recorded]
        else:
            replay = fed
            out["logp"] = generator_first_step_logprobs(gen, short, replay)
            out["fed"] = {"calls": replay.calls, "entries": replay.entries,
                          "differing": replay.differing, "max_step": replay.max_step}
        with watched(logs, plain):
            res, seconds, prefill = generate_run(gen, long, PAR_NEW)
            beam = gen.generate_batch(short[:1], beam_size=2, max_length=PAR_NEW,
                                      include_prompt_in_result=False)
            cb = tt.ContinuousBatcher(gen, num_slots=PAR_SERVE, capacity=256, steps_per_sync=4)
            try:
                if cb._leader:
                    futs = [cb.submit(p, max_length=PAR_NEW) for p in serve]
                    out["serve"] = [f.result(timeout=300).sequences_ids[0] for f in futs]
            finally:
                if cb._leader:
                    cb.close()
                else:
                    cb.join(timeout=300)
                    if cb._thread.is_alive():
                        raise RuntimeError("the follower's batcher did not reach its close")
            torch.cuda.synchronize()
            counts = dict(tt.launch_counts())
        out["greedy"] = [r.sequences_ids[0] for r in res]
        out["beam"] = beam[0].sequences_ids[0]
        out["ms_per_step"] = (seconds - prefill) / (PAR_NEW - 1) * 1e3
        out["prefill_seconds"] = prefill
        # The port's scope profiler (it sees the worker thread that runs the
        # call): its comm:: scopes are the collectives.
        P.init_profiling()
        _, seconds_p, _ = generate_run(gen, long, PAR_NEW)
        comm = {k: v for k, v in P.profiling_totals().items() if k.startswith("comm::")}
        P.dump_profiling()
        out["profiled_seconds"] = seconds_p
        out["collective_ms_per_call"] = sum(v[1] for v in comm.values()) * 1e3
        out["collective_calls"] = {k: v[2] for k, v in comm.items()}
        out["peak_memory_allocated"] = torch.cuda.max_memory_allocated()
    del gen
    free_card()
    return out, logs, counts, plain


def par_small_serve(tt, gen, serve):
    """The serving prompts through a ``ContinuousBatcher`` of ``PAR_SERVE``
    slots (an even count: a data axis of 2 gives each data rank half of
    them): (the leader's tokens, None on a follower; this rank's slots on
    the card and their slot-cache bytes)."""
    cb = tt.ContinuousBatcher(gen, num_slots=PAR_SERVE, capacity=2 * PAR_SERVE_PROMPT,
                              steps_per_sync=4)
    tokens, stats = None, cb.stats()
    try:
        if cb._leader:
            futures = [cb.submit(p, max_length=PAR_NEW) for p in serve]
            tokens = [f.result(timeout=300).sequences_ids[0] for f in futures]
    finally:
        if cb._leader:
            cb.close()
        else:
            cb.join(timeout=300)
            if cb._thread.is_alive():
                raise RuntimeError("the follower's batcher did not reach its close")
    return {"tokens": tokens, "local_slots": stats["local_slots"],
            "slot_cache_bytes": stats["slot_cache_bytes"]}


def par_small_runs(tt, path, vocab, prompts, tensor_parallel=False, data_axis=False):
    """The 2-layer Llama in float32: greedy on the short prompts (split
    over a data axis of 2 with ``data_axis``: the rows of each share this
    rank ran counted) and the ring's prompt (whole on each data rank: the
    ring prefill's calls counted); without a model axis, the serving
    prompts through ``par_small_serve`` (with ``data_axis`` each data rank
    holds and decodes half of the slots)."""
    from ctranslate2_tpu_torch.parallel import context as ctx_par

    short, _, _, ring = prompts
    out = {}
    calls = []

    def count(orig):
        def wrapped(*a, **k):
            calls.append(a[0].shape[2])
            return orig(*a, **k)
        return wrapped

    kw = dict(tensor_parallel=True, device_index=[0, 1]) if data_axis else (
        dict(tensor_parallel=True) if tensor_parallel else {})
    gen = make_generator(tt, path, vocab, compute_type="float32", **kw)
    generate, shares = gen._generate, []

    def counted_generate(starts, *args):
        shares.append(len(starts))
        return generate(starts, *args)

    gen._generate = counted_generate
    out["greedy"] = [r.sequences_ids[0] for r in gen.generate_batch(
        short, max_length=AB_NEW, include_prompt_in_result=False)]
    out["greedy_shares"] = shares
    gen._generate = generate
    with patched(ctx_par, "ring_attention_prefill", count):
        out["ring"] = gen.generate_batch(ring, max_length=4,
                                         include_prompt_in_result=False)[0].sequences_ids[0]
    out["ring_calls"] = calls
    if not tensor_parallel:
        out["serve"] = par_small_serve(tt, gen, prompts[2])
    del gen
    free_card()
    return out


class ReplayShards(ReplayQuantized):
    """``ReplayQuantized`` for a rank of a tensor-parallel model: a
    row-parallel linear quantizes its slice of the input (the whole row's
    scale, over the model group), so its recorded q is cut to the rank's
    columns."""

    def __init__(self, recorded, rank):
        super().__init__(recorded)
        self.rank = rank

    def __call__(self, orig):
        inner = super().__call__(orig)

        def wrapped(q, scale, dtype):
            q_rec, s_rec = self.recorded[self.calls]
            if q_rec.shape[-1] != q.shape[-1]:
                k = q.shape[-1]
                self.recorded[self.calls] = (q_rec[..., self.rank * k:(self.rank + 1) * k],
                                             s_rec)
            return inner(q, scale, dtype)
        return wrapped


def ring_kernel_check(comm):
    """``ring_attention_prefill`` over ``comm`` on random float16 q, k, v of
    the Llama's heads at the ring's prompt against the plain attention on
    the same inputs (float32 softmax, the flash rows' float16 tolerance)."""
    import torch
    from ctranslate2_tpu_torch.parallel.context import ring_attention_prefill

    T = PAR_RING_PROMPT - 1
    D = LLAMA["d_model"] // LLAMA["heads"]
    g = torch.Generator(device="cuda").manual_seed(21)
    q = torch.randn((1, LLAMA["heads"], T, D), generator=g, device="cuda").half()
    k = torch.randn((1, LLAMA["heads_kv"], T, D), generator=g, device="cuda").half()
    v = torch.randn((1, LLAMA["heads_kv"], T, D), generator=g, device="cuda").half()
    out = ring_attention_prefill(q, k, v, scale=D ** -0.5, comm=comm)
    G = LLAMA["heads"] // LLAMA["heads_kv"]
    kk, vv = (t.float().repeat_interleave(G, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * D ** -0.5, kk)
    s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool, device="cuda").tril(), -1e30)
    ref = torch.einsum("bhqk,bhkd->bhqd", s.softmax(-1), vv)
    err = (out.float() - ref).abs().max().item()
    ok = bool(torch.allclose(out.float(), ref, **FLASH_TOL["float16"]))
    return {"shape": list(q.shape), "kv_heads": LLAMA["heads_kv"], "max_abs_err": err,
            "within_tolerance": ok, "tolerance": FLASH_TOL["float16"]}


def tp_rank_main(work):
    """One rank of ``parallel_two_ranks`` (both on card 0, over gloo): the
    runs of ``par_llama_runs`` and ``par_small_runs`` tensor-parallel, the
    Translator's, the ring prefill over a data axis of 2 and the ring
    against the plain attention; results into ``work``."""
    import torch
    import ctranslate2_tpu_torch as tt
    from ctranslate2_tpu_torch.parallel.sharding import initialize_distributed, make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(backend="gloo")
    grid = make_grid(1, "cuda")
    rank = grid.rank
    ref = torch.load(os.path.join(work, "par_ref.pt"), weights_only=False)
    vocab = family_vocab(LLAMA["vocab"])
    prompts = par_prompts(vocab)
    out = {"rank": rank, "backend": torch.distributed.get_backend(),
           "device": str(grid.device)}
    tr = tt.Translator(ref["int8_dir"], compute_type="int8", tensor_parallel=True)
    sents = ref["sentences"]
    replay = ReplayShards(list(ref["translator_recorded"]), grid.model_rank)
    out["translator_logp"] = first_step_logprobs(tr, sents, replay)
    out["translator_fed"] = {"calls": replay.calls, "entries": replay.entries,
                             "differing": replay.differing, "max_step": replay.max_step}
    logs, plain = {}, {}
    with watched(logs, plain):
        out["translator"] = [r.hypotheses for r in tr.translate_batch(sents, **OPTS)]
        torch.cuda.synchronize()
        out["translator_counts"] = dict(tt.launch_counts())
    del tr
    free_card()
    replay = ReplayShards(list(ref["llama"]["recorded"]), grid.model_rank)
    llama, llogs, counts, lplain = par_llama_runs(tt, ref["llama_path"], vocab, prompts,
                                                  fed=replay)
    out["llama"], out["llama_counts"] = llama, counts
    out["small"] = par_small_runs(tt, ref["small_path"], vocab, prompts, tensor_parallel=True)
    out["ring"] = par_small_runs(tt, ref["small_path"], vocab, prompts, data_axis=True)
    data = make_grid(2, "cuda").data
    out["ring_kernel"] = ring_kernel_check(data)
    out["logs"] = {name: {**logs.get(name, {}), **llogs.get(name, {})}
                   for name in set(logs) | set(llogs)}
    out["plain_calls"] = {**plain, **lplain}
    torch.save(out, os.path.join(work, f"par_rank{rank}.pt"))
    print(f"MP_OK rank={rank} backend={out['backend']} device={out['device']}", flush=True)


def nccl_probe_main():
    """One rank of the NCCL probe: both ranks on card 0 in one NCCL
    communicator, one all-reduce."""
    import torch
    import torch.distributed as dist

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=rank, world_size=int(os.environ["WORLD_SIZE"]))
    t = torch.ones(4, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    print(f"MP_OK rank={rank} nccl all_reduce={t.tolist()}", flush=True)
    dist.destroy_process_group()


def parallel_one_rank(tt, int8_dir, llama_path, vocab, sentences, checks):
    """An in-process NCCL group of one rank: ``tensor_parallel=True`` on the
    int8 Translator and the int8 Llama (``MAIN_LAYERS``) must give the
    calls without it to the bit; the group is destroyed after."""
    import torch
    import torch.distributed as dist
    from ctranslate2_tpu_torch.parallel.launch import free_port
    from ctranslate2_tpu_torch.parallel.sharding import shutdown_distributed

    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            rank=0, world_size=1)
    try:
        out = {"backend": dist.get_backend(), "world": dist.get_world_size()}
        runs = []
        for tp in (False, True):
            tr = tt.Translator(int8_dir, compute_type="int8", tensor_parallel=tp)
            res = tr.translate_batch(sentences, **OPTS)
            runs.append([(r.hypotheses, r.scores) for r in res])
            del tr
            free_card()
        checks(runs[0] == runs[1], "parallel_one_rank: the Translator with "
               "tensor_parallel=True gives the call without it to the bit")
        out["translator_bit_equal"] = runs[0] == runs[1]
        short = make_prompts(vocab, PAR_SHORT, 11)[:PAR_ROWS]
        runs = []
        with environ(CT2TPU_KV_CACHE="int8"):
            for tp in (False, True):
                gen = make_generator(tt, llama_path, vocab, compute_type="int8",
                                     tensor_parallel=tp)
                res = gen.generate_batch(short, max_length=PAR_NEW, return_scores=True,
                                         include_prompt_in_result=False)
                runs.append([(r.sequences_ids, r.scores) for r in res])
                del gen
                free_card()
        checks(runs[0] == runs[1], "parallel_one_rank: the Llama with "
               "tensor_parallel=True gives the call without it to the bit")
        out["llama_bit_equal"] = runs[0] == runs[1]
    finally:
        shutdown_distributed()
    checks(not dist.is_initialized(), "parallel_one_rank: the group is destroyed")
    emit({"phase": "parallel_one_rank", "sentences": len(sentences),
          "llama": dict(LLAMA, layers=MAIN_LAYERS), "prompts": [PAR_ROWS, PAR_SHORT],
          "new_tokens": PAR_NEW, "seconds": time.perf_counter() - t0, **out})


def _partings(a, b):
    """The rows of two token lists that part, with the step they part at."""
    out = []
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            step = next((j for j, (s, t) in enumerate(zip(x, y)) if s != t),
                        min(len(x), len(y)))
            out.append({"row": i, "step": step})
    return out


def parallel_two_ranks(tt, int8_dir, llama, vocab, sentences, work, checks, logs):
    """Two ranks on the one card over gloo (NCCL refuses two ranks of one
    communicator on one device: the probe's line), started through
    ``parallel/launch.py``, against this process's one-rank runs of the same
    files: first-step log-probs fed the same int8 activations within
    ``LOGPROB_TOL`` (Translator and the full-width int8 Llama), float32
    tokens of the 2-layer Llama identical (the model axis and the ring
    prefill over a data axis of 2), the ring against the plain attention at
    the flash rows' float16 tolerance; the full-width int8 tokens'
    partings logged, not judged. ``logs`` gets the ranks' kernel shapes."""
    import torch
    from ctranslate2_tpu_torch.parallel.launch import launch

    t0 = time.perf_counter()
    script = os.path.abspath(__file__)
    env = dict(os.environ)
    probe_dir = os.path.join(work, "nccl_probe")
    rc, probe_logs = launch([script, "--nccl-probe"], 2, timeout=PAR_PROBE_TIMEOUT,
                            env=env, log_dir=probe_dir)
    reason = [line.strip() for log in probe_logs for line in log.splitlines()
              if "Duplicate GPU" in line or "Error" in line][:2]
    emit({"phase": "parallel_nccl_probe", "ranks": 2, "card": 0, "rc": rc,
          "nccl_two_ranks_on_one_card": rc == 0, "first_error_lines": reason})

    llama_path = os.path.join(work, "llama_int8")
    small_path = os.path.join(work, "llama_small")
    llama_subset(llama, AB_LAYERS).save(small_path)
    prompts = par_prompts(vocab)
    tr = tt.Translator(int8_dir, compute_type="int8")
    recorded = []
    tr_logp = first_step_logprobs(tr, sentences, record_quantized(recorded))
    tr_hyps = [r.hypotheses for r in tr.translate_batch(sentences, **OPTS)]
    del tr
    free_card()
    one, _, one_counts, _ = par_llama_runs(tt, llama_path, vocab, prompts)
    small = par_small_runs(tt, small_path, vocab, prompts)
    ref = {"int8_dir": int8_dir, "llama_path": llama_path, "small_path": small_path,
           "sentences": sentences, "translator_recorded": [(q.cpu(), s.cpu())
                                                          for q, s in recorded],
           "llama": {"recorded": one["recorded"]}}
    torch.save(ref, os.path.join(work, "par_ref.pt"))
    tr_linears = len(recorded)
    del ref, recorded
    free_card()
    ref_seconds = time.perf_counter() - t0

    t1 = time.perf_counter()
    rc, rank_logs = launch([script, "--tp-rank", work], 2, timeout=PAR_TIMEOUT, env=env,
                           log_dir=os.path.join(work, "tp_ranks"))
    job_seconds = time.perf_counter() - t1
    if rc:
        for r, text in enumerate(rank_logs):
            print(f"--- parallel rank {r} ---\n{text[-6000:]}", file=sys.stderr)
    checks(rc == 0, f"parallel_two_ranks: both ranks ran to their end (rc {rc})")
    if rc:
        return
    ranks = [torch.load(os.path.join(work, f"par_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    fed_first_step = []
    for r, out in enumerate(ranks):
        label = f"parallel_two_ranks rank {r}"
        checks(out["backend"] == "gloo" and out["device"] == "cuda:0",
               f"{label}: gloo on cuda:0 ({out['backend']}, {out['device']})")
        diff = (out["translator_logp"] - tr_logp).abs().max().item()
        fed = out["translator_fed"]
        checks(fed["calls"] == tr_linears > 0 and diff <= LOGPROB_TOL,
               f"{label}: Translator first-step log-probs fed the one-rank run's int8 "
               f"activations within {LOGPROB_TOL} (got {diff})")
        share = fed["differing"] / max(fed["entries"], 1)
        checks(fed["max_step"] <= 1 and share < QUANT_DIFF_SHARE,
               f"{label}: the ranks' own int8 activations are at most one step from the "
               f"one-rank run's on under {QUANT_DIFF_SHARE} of the entries "
               f"(max step {fed['max_step']}, share {share})")
        ldiff = (out["llama"]["logp"] - one["logp"]).abs().max().item()
        lfed = out["llama"]["fed"]
        lshare = lfed["differing"] / max(lfed["entries"], 1)
        checks(lfed["calls"] == len(one["recorded"]) and ldiff <= LOGPROB_TOL,
               f"{label}: Llama first-step log-probs fed the one-rank run's int8 "
               f"activations within {LOGPROB_TOL} (got {ldiff}, {lfed['calls']} of "
               f"{len(one['recorded'])} linears)")
        fed_first_step.append({"translator_logprob_max_abs_diff": diff,
                               "translator_int8_share_differing": share,
                               "llama_logprob_max_abs_diff": ldiff,
                               "llama_int8_share_differing": lshare,
                               "llama_int8_max_step": lfed["max_step"]})
        checks(lfed["max_step"] <= 1 and lshare < QUANT_DIFF_SHARE,
               f"{label}: the Llama's own int8 activations at most one step from the "
               f"one-rank run's on under {QUANT_DIFF_SHARE} (max step "
               f"{lfed['max_step']}, share {lshare})")
        checks(out["small"]["greedy"] == small["greedy"],
               f"{label}: float32 2-layer tokens identical to one rank's")
        checks(out["ring"]["greedy"] == small["greedy"]
               and out["ring"]["greedy_shares"] == [PAR_ROWS // 2],
               f"{label}: float32 2-layer tokens identical to one rank's with the batch "
               f"split over a data axis of 2 (each rank ran rows "
               f"{out['ring']['greedy_shares']})")
        checks(out["ring"]["ring"] == small["ring"] and len(out["ring"]["ring_calls"])
               == AB_LAYERS, f"{label}: the ring prefill fired in every layer "
               f"({out['ring']['ring_calls']}) and its float32 tokens equal one rank's")
        serve = out["ring"]["serve"]
        checks(serve["local_slots"] * 2 == small["serve"]["local_slots"] == PAR_SERVE
               and serve["slot_cache_bytes"] * 2 == small["serve"]["slot_cache_bytes"],
               f"{label}: the data rank holds half of the {PAR_SERVE} serving slots "
               f"({serve['local_slots']}) and half of one rank's slot-cache bytes "
               f"({serve['slot_cache_bytes']} of {small['serve']['slot_cache_bytes']})")
        if r == 0:
            checks(serve["tokens"] == small["serve"]["tokens"],
                   f"{label}: float32 2-layer served tokens identical to one rank's with "
                   f"the slots on a data axis of 2")
        checks(out["ring_kernel"]["within_tolerance"],
               f"{label}: ring attention within the flash rows' float16 tolerance of the "
               f"plain attention ({out['ring_kernel']['max_abs_err']})")
        counts = {k: out["llama_counts"].get(k, 0) + out["translator_counts"].get(k, 0)
                  for k in ("matmul_w8a8", "gather_rows_fused", "flash_attention",
                            "decode_attention_int8", "fused_norm")}
        check_path(label, counts, list(counts), out["plain_calls"], checks)
        half = out["llama"]["param_bytes"] / one["param_bytes"]
        checks(half <= 0.55, f"{label}: the rank holds about half the one-rank payload "
               f"({half:.3f} of it)")
        for name, shapes in out["logs"].items():
            for key, n in shapes.items():
                logs.setdefault(name, {})[key] = logs.get(name, {}).get(key, 0) + n
    lead = ranks[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    emit({"phase": "parallel_two_ranks", "card": smi,
          "label": "two ranks sharing one card over gloo (host-staged collectives): "
                   "not a deployment, no target",
          "backends": [out["backend"] for out in ranks],
          "llama": dict(LLAMA, layers=MAIN_LAYERS), "compute_type": "int8",
          "kv_cache": "int8",
          "prompts": {"first_step": [PAR_ROWS, PAR_SHORT], "greedy": [PAR_ROWS, GEN_PROMPT],
                      "new_tokens": PAR_NEW, "serve": [PAR_SERVE, PAR_SERVE_PROMPT],
                      "ring": PAR_RING_PROMPT},
          "fed_first_step": fed_first_step, "tolerance": LOGPROB_TOL,
          "ms_per_step": {"one_rank": one["ms_per_step"],
                          "two_ranks": [out["llama"]["ms_per_step"] for out in ranks]},
          "prefill_seconds": {"one_rank": one["prefill_seconds"],
                              "two_ranks": [out["llama"]["prefill_seconds"] for out in ranks]},
          "collective_ms_per_greedy_call": [out["llama"]["collective_ms_per_call"]
                                            for out in ranks],
          "profiled_greedy_call_seconds": [out["llama"]["profiled_seconds"] for out in ranks],
          "collective_calls": lead["llama"]["collective_calls"],
          "param_bytes": {"one_rank": one["param_bytes"],
                          "two_ranks": [out["llama"]["param_bytes"] for out in ranks]},
          "peak_memory_allocated": {"one_rank": one["peak_memory_allocated"],
                                    "two_ranks": [out["llama"]["peak_memory_allocated"]
                                                  for out in ranks]},
          "launches_llama": lead["llama_counts"], "launches_translator":
              lead["translator_counts"],
          "partings_int8_not_judged": {
              "translator": _partings(lead["translator"], tr_hyps),
              "greedy": _partings(lead["llama"]["greedy"], one["greedy"]),
              "beam": _partings([lead["llama"]["beam"]], [one["beam"]]),
              "serve": _partings(lead["llama"]["serve"], one["serve"])},
          "data_axis_shares": lead["ring"]["greedy_shares"],
          "data_axis_slot_bytes": {
              "slots": PAR_SERVE, "one_rank": small["serve"]["slot_cache_bytes"],
              "two_ranks": [out["ring"]["serve"]["slot_cache_bytes"] for out in ranks],
              "local_slots": [out["ring"]["serve"]["local_slots"] for out in ranks],
              "served_tokens_identical": lead["ring"]["serve"]["tokens"]
              == small["serve"]["tokens"]},
          "ring_calls": lead["ring"]["ring_calls"], "ring_kernel": lead["ring_kernel"],
          "one_rank_launches": one_counts,
          "reference_seconds": ref_seconds, "job_seconds": job_seconds,
          "seconds": time.perf_counter() - t0})
    shutil.rmtree(small_path, ignore_errors=True)


def parallel_benches(par_logs, seen, checks):
    """The shapes the tensor-parallel ranks gave a kernel that no earlier
    path did (the shards' widths), held against the plain versions
    untimed, in rows of their own."""
    fresh = new_shapes(par_logs, seen)
    extra = dict(summed=False, paths="parallel_two_ranks (the model axis of 2)")
    bench_w8a8(fresh.get("matmul_w8a8", {}), checks, **extra)
    free_card()
    bench_gather(fresh.get("gather_rows_fused", {}), checks, **extra)
    bench_flash(fresh.get("flash_attention", {}), checks, **extra)
    free_card()
    bench_decode(fresh.get("decode_attention_int8", {}), GEN_PROMPT - 1, PAR_NEW, checks,
                 **extra)
    bench_norm(fresh.get("fused_norm", {}), checks, **extra)
    free_card()
    emit({"phase": "parallel_shapes", "shapes": {name: sorted(map(str, shapes))
                                                 for name, shapes in fresh.items()}})


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--tp-rank"]:
        tp_rank_main(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--nccl-probe"]:
        nccl_probe_main()
        return 0
    import ctranslate2_tpu_torch as tt
    from ctranslate2_tpu_torch.converters.builder import build_seq2seq_model
    from ctranslate2_tpu_torch.formats.vocabulary import Vocabulary
    from ctranslate2_tpu_torch import native
    from ctranslate2_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = Checks()
    started = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    # The native host core (g++) builds while nvcc builds the kernels.
    native_build = {}

    def build_native():
        try:
            t0 = time.perf_counter()
            native_build["path"] = native.build()
            native_build["seconds"] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 - raised again below
            native_build["error"] = e

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    # The converting subprocess of ``convert_and_run`` needs no card: it
    # runs beside the builds.
    conversion = start_conversion()
    build_seconds = build.build(ptxas_report=PTXAS_REPORT)
    native_thread.join()
    if "error" in native_build:
        raise native_build["error"]
    emit({"phase": "ptxas", "report": {
        name: ptxas_summary(build.PTXAS_LOG.get(name, "")) for name in PTXAS_REPORT}})
    emit({"phase": "card", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi[0] if smi else None, "torch": torch.__version__,
          "cuda": torch.version.cuda, "kernels_built": list(build.KERNEL_SOURCES),
          "kernel_build_seconds": build_seconds,
          "kernel_build_seconds_by_source": dict(build.BUILD_SECONDS),
          "kernel_build_units": build.KERNEL_UNITS,
          "native_build_seconds": native_build["seconds"]})

    w8a8_memset_check(checks)
    work = tempfile.mkdtemp(prefix="smoke_", dir=build.build_dir())
    try:
        t0 = time.perf_counter()
        int8_dir = build_seq2seq_model(os.path.join(work, "int8"), quantization="int8", **MODEL)
        float_dir = build_seq2seq_model(os.path.join(work, "float"), **MODEL)
        # The same widths at half the depth: the replicas and the profiled
        # serving block (the run's time limit).
        half_dir = build_seq2seq_model(os.path.join(work, "int8_half"), quantization="int8",
                                       **dict(MODEL, num_layers=HALF_LAYERS))
        emit({"phase": "models", "config": MODEL, "half_layers": HALF_LAYERS,
              "seconds": time.perf_counter() - t0})

        # ---- main path 1: Translator ----
        logs = {}
        vocab = Vocabulary.load(int8_dir, "shared_vocabulary")
        batches = [make_batch(vocab, i) for i in range(1 + ITERS)]
        tr_counts = main_path(tt, int8_dir, "int8", batches, checks, "int8", logs)
        for name in ("matmul_w8a8", "gather_rows_fused", "fused_norm"):
            checks(tr_counts[name] > 0,
                   f"{name} launched on the Translator main path ({tr_counts[name]})")
        free_card()
        # Shapes of the paths after the main ones: benched in rows of their own.
        new_logs = {}
        score_translator(tt, int8_dir, batches[1], checks, new_logs)
        free_card()
        host_loop_translator(tt, int8_dir, vocab, batches[1], checks, new_logs)
        free_card()
        file_helpers_translator(tt, int8_dir, batches, work, checks, new_logs)
        free_card()
        serving_translator(tt, int8_dir, batches, checks, new_logs)
        free_card()
        residency_translator(tt, int8_dir, batches[1], checks)
        free_card()
        beam_logs = {}
        ct_greedy = continuous_translator(tt, int8_dir, batches, checks, beam_logs, half_dir)
        free_card()
        spec_logs = {}
        continuous_translator_spec(tt, int8_dir, batches, work, checks, spec_logs, ct_greedy)
        del ct_greedy
        free_card()
        # ---- the host core: native module, CLI, scheduler, replicas ----
        core_started = time.perf_counter()
        core_logs = {}
        host_core_native(checks, native_build["seconds"], native_build["path"])
        host_core_cli(tt, int8_dir, batches, work, checks, core_logs)
        free_card()
        host_core_scheduler(tt, int8_dir, batches, checks, core_logs)
        free_card()
        host_core_replicas(tt, half_dir, batches, checks, core_logs)
        free_card()
        core_seconds = time.perf_counter() - core_started

        # ---- main path 2: Generator ----
        t0 = time.perf_counter()
        llama = build_llama_modelfile(MAIN_LAYERS)
        llama_vocab = family_vocab(LLAMA["vocab"])
        llama_payload_bytes = sum(v.array.nbytes for n, v in llama.variables.items()
                                  if n.endswith("/weight"))
        emit({"phase": "llama_model", "config": dict(LLAMA, layers=MAIN_LAYERS),
              "int8_weight_bytes": llama_payload_bytes,
              "seconds": time.perf_counter() - t0})
        # ---- the host core: the zero-copy load of this model ----
        t0 = time.perf_counter()
        host_core_load(tt, llama, work, checks)
        core_seconds += time.perf_counter() - t0
        emit({"phase": "host_core", "seconds": core_seconds})
        # ---- tensor parallelism: one NCCL rank, then two ranks over gloo ----
        t0 = time.perf_counter()
        par_sentences = batches[1][:PAR_SENTENCES]
        parallel_one_rank(tt, int8_dir, os.path.join(work, "llama_int8"), llama_vocab,
                          par_sentences, checks)
        free_card()
        par_logs = {}
        parallel_two_ranks(tt, int8_dir, llama, llama_vocab, par_sentences, work, checks,
                           par_logs)
        shutil.rmtree(os.path.join(work, "llama_int8"), ignore_errors=True)
        free_card()
        emit({"phase": "parallel", "seconds": time.perf_counter() - t0})
        plain_calls = {}
        gen_counts, gen = generator_main_path(tt, llama, llama_vocab, checks, logs,
                                              plain_calls)
        for name in ("matmul_w8a8", "flash_attention", "decode_attention_int8",
                     "fused_norm"):
            checks(gen_counts[name] > 0,
                   f"{name} launched on the Generator main path ({gen_counts[name]})")
        free_card()

        # ---- the teacher-forced and sampled paths on the same model ----
        score_generator(tt, gen, llama_vocab, checks, new_logs)
        free_card()
        with environ(CT2TPU_KV_CACHE="int8"):
            side_gen = make_generator(tt, llama_subset(llama, SIDE_LAYERS), llama_vocab,
                                      compute_type="int8")
        sampling_phase(tt, side_gen, llama_vocab, int8_dir, batches[1], checks, new_logs)
        free_card()
        host_loop_generator(tt, side_gen, llama_vocab, checks, new_logs)
        free_card()
        file_helpers_generator(tt, side_gen, llama_vocab, checks, new_logs)
        free_card()
        serve_logs = {}
        serving_generator(tt, side_gen, llama_vocab, checks, serve_logs)
        free_card()
        greedy = serving_generator_beam(tt, gen, checks, beam_logs, side_gen)
        del side_gen
        free_card()
        speculation_generator(tt, gen, llama_vocab, checks, spec_logs, plain_calls)
        del plain_calls
        serving_generator_spec(tt, gen, llama_vocab, checks, spec_logs, greedy)
        del greedy
        free_card()
        residency_generator(tt, gen, llama_vocab, llama_payload_bytes, checks)
        del gen
        small_llama = llama_subset(llama, AB_LAYERS)
        del llama
        free_card()

        # ---- main path 3: Generator on AWQ-W4 weights ----
        t0 = time.perf_counter()
        awq = build_awq_llama_modelfile(AWQ_LAYERS)
        emit({"phase": "awq_model", "config": dict(LLAMA, layers=AWQ_LAYERS), "group": AWQ_GROUP,
              "layout": "AutoAWQ GEMM (quantization_type 1)",
              "host_bytes": sum(v.array.nbytes for v in awq.variables.values()),
              "seconds": time.perf_counter() - t0})
        awq_logs = {}
        awq_counts, awq_unpacked_counts = generator_awq_main_path(
            tt, awq, llama_vocab, checks, awq_logs)
        for name in ("matmul_w4p", "flash_attention", "decode_attention_int8",
                     "fused_norm"):
            checks(awq_counts[name] > 0,
                   f"{name} launched on the AWQ Generator main path ({awq_counts[name]})")
        checks(awq_unpacked_counts["matmul_w4a16"] > 0,
               "matmul_w4a16 launched on the unpacked AWQ call "
               f"({awq_unpacked_counts['matmul_w4a16']})")
        small_awq = llama_subset(awq, AB_LAYERS)
        del awq
        free_card()

        # ---- the Encoder at BERT-base's widths ----
        t0 = time.perf_counter()
        bert = build_bert_modelfile(BERT["layers"])
        emit({"phase": "bert_model", "config": BERT, "seconds": time.perf_counter() - t0})
        encoder_phase(tt, bert, checks, new_logs)
        small_bert = encoder_subset(bert, AB_LAYERS)
        del bert
        free_card()

        # ---- the architecture features at four families' widths ----
        arch_logs = {}
        architectures_phase(tt, work, checks, arch_logs)
        free_card()

        # ---- the speech models at their published widths ----
        speech_logs = {"whisper": {}, "wav2vec2": {}, "w2v_bert": {}}
        t0 = time.perf_counter()
        whisper_phase(tt, work, checks, speech_logs["whisper"])
        continuous_whisper(tt, work, checks, beam_logs)
        continuous_whisper_spec(tt, work, checks, spec_logs)
        wav2vec2_phase(tt, checks, speech_logs["wav2vec2"])
        w2v_bert_phase(tt, checks, speech_logs["w2v_bert"])
        emit({"phase": "speech", "seconds": time.perf_counter() - t0})

        # ---- every kernel against its plain version ----
        w8 = bench_w8a8(logs["matmul_w8a8"], checks)
        ga = bench_gather(logs["gather_rows_fused"], checks)
        fl = bench_flash(logs["flash_attention"], checks)
        free_card()
        de = bench_decode(logs["decode_attention_int8"], GEN_PROMPT - 1, GEN_NEW, checks)
        with untimed():
            bench_gemma2_attention(checks)
        no = bench_norm(logs["fused_norm"], checks, awq_logs.get("fused_norm"))
        feature_checks(checks)
        w4 = bench_w4(awq_logs, checks)
        free_card()
        # The rows below (the W4 crossover and the shapes of the
        # paths after the main ones, not summed into the totals) are held
        # against their plain versions untimed: PERF.md records their times
        # from earlier runs, and timing them again took about 140 s.
        with untimed():
            bench_w4_crossover(checks)
            free_card()
            fresh = new_shapes(new_logs, logs)
            extra = dict(summed=False, paths="score_generator, score_translator, encoder, "
                                             "sampling, host_loop_translator, "
                                             "host_loop_generator, file_helpers")
            bench_w8a8(fresh.get("matmul_w8a8", {}), checks, **extra)
            free_card()
            bench_flash(fresh.get("flash_attention", {}), checks, **extra)
            free_card()
            bench_norm(fresh.get("fused_norm", {}), checks, **extra)
            bench_gather(fresh.get("gather_rows_fused", {}), checks, **extra)
            bench_decode(fresh.get("decode_attention_int8", {}), GEN_PROMPT - 1, SAMPLE_NEW,
                         checks, **extra)
            free_card()
            seen = {name: {**logs.get(name, {}), **new_logs.get(name, {}),
                           **awq_logs.get(name, {})}
                    for name in set(logs) | set(new_logs) | set(awq_logs)}
            seen = arch_benches(arch_logs, seen, checks)
            seen = arch_benches(speech_logs, seen, checks, prefix="")
            serving_benches(serve_logs, checks)
            seen = {name: {**seen.get(name, {}), **serve_logs.get(name, {})}
                    for name in set(seen) | set(serve_logs)}
            serving_beam_benches(beam_logs, seen, checks)
            seen = {name: {**seen.get(name, {}), **beam_logs.get(name, {})}
                    for name in set(seen) | set(beam_logs)}
            speculation_benches(spec_logs, seen, checks)
            seen = {name: {**seen.get(name, {}), **spec_logs.get(name, {})}
                    for name in set(seen) | set(spec_logs)}
            parallel_benches(par_logs, seen, checks)

        # ---- the other Translator runs ----
        f16_counts = main_path(tt, float_dir, "float16", batches, checks, "float16", {})
        checks(f16_counts["matmul_w8a8"] == 0, "float16 runs no W8A8 launch")
        chain_float32(tt, float_dir, batches[1], checks)
        free_card()
        card_vs_cpu(tt, int8_dir, batches[1], checks)
        free_card()
        convert_and_run(tt, conversion, checks, {})
        free_card()

        # ---- the other Generator runs ----
        generator_ab(tt, small_llama, llama_vocab, checks)
        free_card()
        pair = card_cpu_generators(tt, small_llama, llama_vocab)
        generator_card_vs_cpu(tt, pair, llama_vocab, checks)
        free_card()
        generator_awq_checks(tt, small_awq, llama_vocab, checks)
        free_card()
        teacher_forced_card_vs_cpu(tt, pair, llama_vocab, small_bert, checks)
        free_card()
        small_dir = build_seq2seq_model(os.path.join(work, "small"),
                                        **dict(MODEL, num_layers=AB_LAYERS))
        host_loop_card_vs_cpu(tt, small_dir, pair, llama_vocab, vocab, batches[1], checks)
        free_card()
        serving_card_vs_cpu(tt, pair, llama_vocab, checks)
        serving_beam_card_vs_cpu(tt, pair, small_dir, llama_vocab, vocab, checks)
        speculation_card_vs_cpu(tt, pair, small_llama, small_dir, llama_vocab, vocab, checks)
        del pair
        free_card()
        architectures_card_vs_cpu(tt, work, checks)
        free_card()
        speech_card_vs_cpu(tt, work, checks)
        continuous_whisper_card_vs_cpu(tt, work, checks)
        speculation_whisper_card_vs_cpu(tt, work, checks)

        def entry(name, source, replaces, tot, library_ms, launches=None, **extra):
            """One kernel's line; ``launches`` defaults to the Translator and
            int8 Generator paths' counts, over which its times are summed."""
            bytes_ms, ops_ms = tot["bytes_ms"], tot.get("ops_ms", 0.0)
            if launches is None:
                launches = tr_counts[name] + gen_counts[name]
                extra = dict(extra, launches_translator_path=tr_counts[name],
                             launches_generator_path=gen_counts[name],
                             launches_awq_generator_path_not_summed=awq_counts[name])
            return {"name": name, "route": "cuda",
                    "source": f"ctranslate2_tpu_torch/csrc/{source}",
                    "replaces": f"ctranslate2_tpu/kernels/{replaces}",
                    "launches": launches, "max_abs_err": tot["max_abs_err"],
                    "ms": tot["ms"], "plain_ms": tot["plain_ms"],
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                    "library_ms": library_ms, "ms_summed_over": "launches", **extra}

        def w4_entry(name, replaces, launches, **extra):
            return entry(name, "w4_gemm.cu", replaces, w4[name], w4[name]["library_ms"],
                         launches, library=w4[name]["libraries"], **extra)

        kernels = [
            entry("matmul_w8a8", "w8a8_gemm.cu", "quant_matmul.py:238", w8,
                  w8["library_ms"]),
            entry("gather_rows_fused", "gather_rows.cu", "gather_rows.py:27", ga,
                  ga["plain_ms"]),
            entry("flash_attention", "flash_attention.cu", "flash_attention.py:185",
                  fl, fl["library_ms"]),
            entry("decode_attention_int8", "decode_attention_int8.cu",
                  "decode_attention.py:135", de, None),
            entry("fused_norm", "fused_norm.cu", "norms.py:37", no, no["library_ms"],
                  library="F.rms_norm / F.layer_norm of the norm alone",
                  replaced_ms=no["replaced_ms"], forms=no["forms"]),
            w4_entry("matmul_w4a16", "quant_matmul.py:77",
                     awq_unpacked_counts["matmul_w4a16"],
                     launches_awq_unpacked_call=awq_unpacked_counts["matmul_w4a16"]),
            w4_entry("matmul_w4p", "quant_matmul.py:333", awq_counts["matmul_w4p"],
                     launches_awq_generator_path=awq_counts["matmul_w4p"]),
            w4_entry("matmul_w4a16_fold", "quant_matmul.py:157", 0,
                     ms_summed_over="the launches of matmul_w4a16 at the same shapes "
                                    "(linear() never dispatches the folded form)"),
            w4_entry("matmul_w4p_fold", "quant_matmul.py:431", 0,
                     ms_summed_over="the launches of matmul_w4p at the same shapes "
                                    "(linear() never dispatches the folded form)"),
        ]
    finally:
        shutil.rmtree(work, ignore_errors=True)

    emit({"phase": "done", "seconds": time.perf_counter() - started,
          "checks_failed": len(checks.failed)})
    if checks.failed:
        print(f"chip_smoke: {len(checks.failed)} check(s) failed: {checks.failed}",
              file=sys.stderr)
        return 1
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
