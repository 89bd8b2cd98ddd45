"""Local launcher of N tensor-parallel ranks (the counterpart of the JAX
package's ``tools/run_multiprocess.py``, and of ``torchrun`` on one host).

    python -m ctranslate2_tpu_torch.parallel.launch --num-processes 2 \\
        [--timeout 600] [--log-dir DIR] [SCRIPT [ARGS ...]]

starts ``python SCRIPT ARGS`` N times with ``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (a free local port,
never a fixed one) in the environment, from which ``tensor_parallel=True``
initialises the process group. Each rank must print ``MP_OK rank=<i> ...``;
the launcher returns non-zero when a rank fails, times out or prints no
such line, and ``MULTIPROCESS_OK processes=N`` when all succeed. Without
a script each rank runs ``self_check``: a tiny decoder-only model (the
port's builder, on the CPU or with ``--device cuda`` on the rank's card)
generated greedy and with beam 2, tensor-parallel against the same model
unsharded in the same process.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Tuple


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], num_processes: int, timeout: float = 600.0,
           env: Optional[dict] = None, log_dir: Optional[str] = None
           ) -> Tuple[int, List[str]]:
    """Runs ``python *argv`` as ranks 0..N-1 of one job; returns (rc, each
    rank's output). rc is 0 only when every rank exits 0 within ``timeout``
    seconds and prints its ``MP_OK rank=<i>`` line; at the deadline or the
    first rank's failure every rank still running is killed."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="ct2tpu_torch_mp_")
    os.makedirs(log_dir, exist_ok=True)
    base = dict(os.environ if env is None else env)
    base.setdefault("OMP_NUM_THREADS", "1")
    port = str(free_port())
    procs, logs = [], []
    for rank in range(num_processes):
        rank_env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank),
                        WORLD_SIZE=str(num_processes),
                        LOCAL_WORLD_SIZE=str(num_processes),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        log = open(os.path.join(log_dir, f"rank{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen([sys.executable, *argv], env=rank_env,
                                      stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    rc = 0
    # A rank that fails leaves the others waiting in a collective: stop
    # them all at the first failure or at the deadline.
    while any(p.poll() is None for p in procs):
        if (time.monotonic() > deadline
                or any(p.returncode not in (None, 0) for p in procs)):
            rc = 1
            break
        time.sleep(0.05)
    for p in procs:  # stop every process started, whatever happened
        if p.poll() is None:
            p.kill()
            p.wait()
    outputs = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        out = log.read()
        log.close()
        outputs.append(out)
        if p.returncode != 0 or f"MP_OK rank={rank}" not in out:
            rc = 1
    return rc, outputs


def self_check(device: str = "cpu") -> None:
    """One rank's check: greedy and beam-2 generation of a tiny model
    tensor-parallel over the job's ranks equal the unsharded model's."""
    import torch

    torch.set_num_threads(1)
    from .. import Generator
    from ..converters.builder import build_decoder_only_model
    from .sharding import device_info

    rank = int(os.environ.get("RANK", "0"))
    path = tempfile.mkdtemp(prefix=f"ct2tpu_torch_check{rank}_")
    build_decoder_only_model(path, vocab_size=64, num_layers=2, num_heads=8,
                             num_heads_kv=4, d_model=64, d_ff=128, rotary_dim=0,
                             glu=True, rms_norm=True, activation="swish")
    prompts = [["tok1", "tok2"], ["tok3"], ["tok4", "tok1", "tok5"]]
    tp = Generator(path, device=device, tensor_parallel=True, compute_type="float32")
    ref = Generator(path, device=device, device_index=tp.model.device.index or 0,
                    compute_type="float32")
    for kw in ({"max_length": 8, "return_scores": True},
               {"max_length": 8, "beam_size": 2, "num_hypotheses": 2}):
        got = tp.generate_batch(prompts, **kw)
        want = ref.generate_batch(prompts, **kw)
        assert [r.sequences_ids for r in got] == [r.sequences_ids for r in want], (got, want)
    info = device_info()
    print(f"MP_OK rank={rank} processes={info['process_count']} device={tp.model.device} "
          f"greedy={got[0].sequences_ids[0]}", flush=True)


def main(args: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--device", default="cpu",
                    help="the self-check's device (without a script)")
    ap.add_argument("--self-check", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("script", nargs=argparse.REMAINDER)
    a = ap.parse_args(args)
    if a.self_check:
        self_check(a.device)
        return 0
    argv = a.script or ["-m", "ctranslate2_tpu_torch.parallel.launch", "--self-check",
                        "--device", a.device]
    rc, outputs = launch(argv, a.num_processes, a.timeout, log_dir=a.log_dir)
    for rank, out in enumerate(outputs):
        ok = [line for line in out.splitlines() if line.startswith(f"MP_OK rank={rank}")]
        print(f"--- rank {rank}: {ok[0] if ok else 'FAILED'}")
        if not ok:
            print(out[-4000:])
    if rc == 0:
        print(f"MULTIPROCESS_OK processes={a.num_processes}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
