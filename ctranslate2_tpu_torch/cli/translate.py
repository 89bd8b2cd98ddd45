"""``ct2tpu-torch-translator``: file translation / scoring client
(parity with reference: cli/translator.cc:12-257), with the options and
the output of ``ctranslate2_tpu/cli/translate.py``.

Usage:
    python -m ctranslate2_tpu_torch.cli.translate --model <dir> --src in.txt --out out.txt

``--device`` is ``cuda`` by default (the card, as ``auto``; it raises
where there is none) or ``cpu``; ``--log_throughput`` prints the target tokens per second
and ``--log_profiling`` the profiler's table of scopes to stderr.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "ct2tpu-torch-translator",
        description="ctranslate2_tpu_torch translator client")
    # General.
    p.add_argument("--task", default="translate", choices=["translate", "score"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log_throughput", action="store_true")
    p.add_argument("--log_profiling", action="store_true")
    # Device.
    p.add_argument("--device", default="cuda", choices=["cuda", "auto", "cpu"])
    p.add_argument("--inter_threads", type=int, default=1)
    p.add_argument("--intra_threads", type=int, default=0)
    # Model.
    p.add_argument("--model", required=True)
    p.add_argument("--compute_type", default="default")
    # Data.
    p.add_argument("--src", default=None)
    p.add_argument("--tgt", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--read_batch_size", type=int, default=0)
    p.add_argument("--batch_type", default="examples",
                   choices=["examples", "tokens"])
    p.add_argument("--max_input_length", type=int, default=1024)
    # Decoding.
    p.add_argument("--beam_size", type=int, default=2)
    p.add_argument("--patience", type=float, default=1.0)
    p.add_argument("--sampling_topk", type=int, default=1)
    p.add_argument("--sampling_topp", type=float, default=1.0)
    p.add_argument("--sampling_temperature", type=float, default=1.0)
    p.add_argument("--length_penalty", type=float, default=1.0)
    p.add_argument("--coverage_penalty", type=float, default=0.0)
    p.add_argument("--repetition_penalty", type=float, default=1.0)
    p.add_argument("--no_repeat_ngram_size", type=int, default=0)
    p.add_argument("--max_decoding_length", type=int, default=256)
    p.add_argument("--min_decoding_length", type=int, default=1)
    p.add_argument("--num_hypotheses", type=int, default=1)
    p.add_argument("--with_score", action="store_true")
    p.add_argument("--use_vmap", action="store_true")
    p.add_argument("--replace_unknowns", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .. import Translator, set_random_seed
    from ..utils.profiler import init_profiling, dump_profiling

    set_random_seed(args.seed)
    if args.log_profiling:
        init_profiling()

    translator = Translator(
        args.model, device=args.device, compute_type=args.compute_type,
        inter_threads=args.inter_threads, intra_threads=args.intra_threads)

    src = open(args.src, encoding="utf-8") if args.src else sys.stdin
    out = open(args.out, "w", encoding="utf-8") if args.out else sys.stdout
    tgt = open(args.tgt, encoding="utf-8") if args.tgt else None

    options = dict(
        beam_size=args.beam_size,
        patience=args.patience,
        sampling_topk=args.sampling_topk,
        sampling_topp=args.sampling_topp,
        sampling_temperature=args.sampling_temperature,
        length_penalty=args.length_penalty,
        coverage_penalty=args.coverage_penalty,
        repetition_penalty=args.repetition_penalty,
        no_repeat_ngram_size=args.no_repeat_ngram_size,
        max_decoding_length=args.max_decoding_length,
        min_decoding_length=args.min_decoding_length,
        num_hypotheses=args.num_hypotheses,
        max_input_length=args.max_input_length,
        use_vmap=args.use_vmap,
        replace_unknowns=args.replace_unknowns,
        return_scores=args.with_score,
    )

    start = time.time()
    num_tokens = 0

    # Streaming consume loop like the reference client
    # (reference: cli/translator.cc -> consume_batches,
    # replica_pool.h:191-226).
    import itertools

    from ..runtime.batching import consume_stream, default_read_batch_size

    read_bs = default_read_batch_size(args.read_batch_size, args.batch_size)

    def read_window():
        window = list(itertools.islice(src, read_bs))
        if not window:
            if tgt is not None and tgt.readline():
                raise SystemExit(
                    "source and target files do not have the same number "
                    "of lines")
            return None
        lines = [line.rstrip("\n").split() for line in window]
        tgt_lines = None
        if tgt is not None:
            tgt_lines = [line.rstrip("\n").split()
                         for line in itertools.islice(tgt, len(window))]
            if len(tgt_lines) != len(lines):
                raise SystemExit(
                    "source and target files do not have the same number "
                    "of lines")
        return lines, tgt_lines

    def submit(window):
        lines, tgt_lines = window
        if args.task == "score":
            return translator.score_batch(
                lines, tgt_lines, max_batch_size=args.batch_size,
                batch_type=args.batch_type, asynchronous=True)
        return translator.translate_batch(
            lines, tgt_lines, max_batch_size=args.batch_size,
            batch_type=args.batch_type, asynchronous=True, **options)

    def write_score(r):
        nonlocal num_tokens
        num_tokens += len(r.tokens)
        out.write("%f ||| %s\n" % (r.normalized_score(), " ".join(r.tokens)))

    def write_translation(r):
        nonlocal num_tokens
        for h in range(len(r.hypotheses)):
            num_tokens += len(r.hypotheses[h])
            if args.with_score and r.scores:
                out.write("%f ||| " % r.scores[h])
            out.write(" ".join(r.hypotheses[h]))
            out.write("\n")

    writer = write_score if args.task == "score" else write_translation
    consume_stream(read_window, submit, writer,
                   max_pending=4 * (read_bs or 0))

    elapsed = time.time() - start
    if args.log_throughput:
        print("Tokens per second: %.2f" % (num_tokens / max(elapsed, 1e-9)),
              file=sys.stderr)
    if args.log_profiling:
        dump_profiling(sys.stderr)

    if args.src:
        src.close()
    if args.out:
        out.close()
    if tgt:
        tgt.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
