"""Multi-batch dispatch serving sweep on one CUDA card.

The port of cobs_tpu's experiments/mega_serve_bench.py: the serving loop
(`Search.search_stream`: host stage, a bounded window of dispatched
batches, groups of `mega` batches in one upload and one launch of each
kernel) at interleaved (B, mega) configs in one process, the best of
each over `--rounds` rounds, after a warm-up pass of each. Prints

    RESULT name=mega_serve B=<B> mega=<mega> threshold=<t> limit=<l>
        queries_per_s=<q/s>

    python -m cobs_tpu_torch.experiments.mega_serve_bench INDEX \\
        [--queries 32768] [--rounds 3] [--configs 2048:1,2048:8,...]

A config is B:mega. cobs_tpu's configs may go on with
:tier:ahead:groups:prepack, the top-k tier fetch, the hash-ahead depth,
the dispatched-ahead groups and the worker-side query pack: knobs for a
chip behind a slow remote link, which the port does not have ("Port
behaviour, not the TPU-tunnel workarounds", ROADMAP.md). Such a config
is refused, never ignored. `--device cpu` serves with the kernels' plain
versions (tests only).
"""

import argparse
import time

from cobs_tpu_torch.experiments.paper_scale import random_queries

DEFAULT_CONFIGS = "2048:1,2048:8,2048:16,1024:16,1024:1"
_TPU_KNOBS = ("tier", "ahead", "groups", "prepack")


def parse_configs(text: str) -> list[tuple[int, int]]:
    """"B:mega,..." -> [(B, mega), ...]; raises ValueError on a config
    that names cobs_tpu's TPU-link knobs or is malformed."""
    out = []
    for c in text.split(","):
        parts = c.split(":")
        if len(parts) > 2:
            named = ", ".join(_TPU_KNOBS[:len(parts) - 2])
            raise ValueError(
                f"config {c!r} sets {named}: cobs_tpu's knobs for a TPU "
                "behind a remote link, not ported (ROADMAP.md ground rule "
                "'Port behaviour, not the TPU-tunnel workarounds'); give "
                "B:mega")
        if len(parts) != 2:
            raise ValueError(f"config {c!r} is not B:mega")
        B, mega = (int(x) for x in parts)
        if B < 1 or mega < 1:
            raise ValueError(f"config {c!r}: B and mega must be >= 1")
        out.append((B, mega))
    return out


def rep(s, settings, B: int, mega: int, queries, threshold: float,
        limit: int, keep: bool = False):
    """(q/s, seconds, the ranked lists if `keep`) of one search_stream
    pass at batch size B with settings.mega_batches = mega (restored
    after)."""
    old = settings.mega_batches
    settings.mega_batches = mega
    got = [] if keep else None
    try:
        t0 = time.perf_counter()
        n = 0
        for res in s.search_stream(queries, threshold, limit, batch_size=B):
            n += 1
            if keep:
                got.append(res)
        dt = time.perf_counter() - t0
    finally:
        settings.mega_batches = old
    return n / dt, dt, got


def sweep(s, settings, configs, queries, rounds: int, threshold: float,
          limit: int, log=print) -> dict:
    """(B, mega) -> best q/s: a warm-up pass of B * mega queries each,
    then the configs in turns for `rounds` rounds."""
    for B, mega in configs:
        qps, dt, _ = rep(s, settings, B, mega, queries[:B * mega],
                         threshold, limit)
        log(f"warmup {(B, mega)}: {qps:.0f} q/s ({dt:.1f}s)")
    best = {}
    for rnd in range(1, rounds + 1):
        for cfg in configs:
            qps, dt, _ = rep(s, settings, *cfg, queries, threshold, limit)
            best[cfg] = max(best.get(cfg, 0.0), qps)
            log(f"round {rnd} {cfg}: {qps:.0f} q/s ({dt:.1f}s)")
    return best


def result_line(B: int, mega: int, threshold: float, limit: int,
                qps: float) -> str:
    return (f"RESULT name=mega_serve B={B} mega={mega} threshold={threshold} "
            f"limit={limit} queries_per_s={qps:.1f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("index")
    ap.add_argument("--num-kmers", type=int, default=1000)
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--threshold", type=float, default=0.8)
    ap.add_argument("--limit", type=int, default=100,
                    help="top-k per query (the reference default query "
                         "mode is -t 0.8 -l 100)")
    ap.add_argument("--configs", default=DEFAULT_CONFIGS,
                    help="comma list of B:mega (queries per batch, batches "
                         "per dispatch); put variants in one list for an "
                         "interleaved A/B")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    try:
        configs = parse_configs(args.configs)
    except ValueError as e:
        ap.error(str(e))

    from cobs_tpu_torch.query.search import Search
    from cobs_tpu_torch.settings import settings

    queries = random_queries(args.queries, args.num_kmers)
    print(f"index={args.index} queries={len(queries)} "
          f"T={args.num_kmers} limit={args.limit}", flush=True)
    s = Search(args.index, device=args.device)
    best = sweep(s, settings, configs, queries, args.rounds, args.threshold,
                 args.limit, log=lambda m: print(m, flush=True))
    for (B, mega), qps in sorted(best.items()):
        print(result_line(B, mega, args.threshold, args.limit, qps))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
