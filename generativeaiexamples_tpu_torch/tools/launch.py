"""Start N processes of one module with JAX's env contract set: the
one-host stand-in for the cluster that sets ``COORDINATOR_ADDRESS``,
``NUM_PROCESSES`` and ``PROCESS_ID`` (parallel/multihost.py).

    python -m generativeaiexamples_tpu_torch.tools.launch --nproc 2 -- \\
        generativeaiexamples_tpu_torch.tools.finetune --dp 2 --data d.jsonl ...

Each child runs ``python -m <module> <args>`` with
``COORDINATOR_ADDRESS=127.0.0.1:<a free port>``, ``NUM_PROCESSES=N`` and
``PROCESS_ID=i``; ``CUDA_VISIBLE_DEVICES`` is left as it is, and process
``i`` drives ``cuda:(i % device_count)`` (``multihost.local_device``).
The children share this process's standard output and error.

The run fails as a whole: the first child to exit non-zero has the others
killed, and its exit code is the launcher's; a signal to the launcher
kills every child. It exits 0 only when every child did.
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List

POLL_S = 0.05
# how long a child has to end after SIGTERM before it is killed
TERM_GRACE_S = 5.0


def free_port() -> int:
    """A TCP port free on the loopback address now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def parse_args(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="N processes of one module under JAX's env contract")
    p.add_argument("--nproc", type=int, required=True, help="processes to start")
    p.add_argument("module", help="the module each process runs (python -m)")
    p.add_argument("args", nargs=argparse.REMAINDER, help="the module's arguments")
    args = p.parse_args(argv)
    if args.nproc < 1:
        p.error(f"--nproc must be >= 1, got {args.nproc}")
    return args


def _stop(procs: List[subprocess.Popen]) -> None:
    """SIGTERM every child still running, then SIGKILL what outlives the
    grace period; reaps them all."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + TERM_GRACE_S
    for p in procs:
        try:
            p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch(nproc: int, module: str, args: List[str]) -> int:
    """Run the ``nproc`` children to their end; the exit code of the run."""
    if args[:1] == ["--"]:
        args = args[1:]
    base = dict(os.environ, COORDINATOR_ADDRESS=f"127.0.0.1:{free_port()}",
                NUM_PROCESSES=str(nproc))
    procs: List[subprocess.Popen] = []

    def on_signal(signum, frame):
        raise KeyboardInterrupt(f"signal {signum}")

    previous = {s: signal.signal(s, on_signal) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for i in range(nproc):
            procs.append(subprocess.Popen([sys.executable, "-m", module, *args],
                                          env=dict(base, PROCESS_ID=str(i))))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                print(f"launch: a process exited {failed[0]}; stopping the others",
                      file=sys.stderr, flush=True)
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(POLL_S)
    except KeyboardInterrupt:
        return 128 + signal.SIGTERM
    finally:
        _stop(procs)
        for s, handler in previous.items():
            signal.signal(s, handler)


def main(argv: List[str] | None = None) -> int:
    a = parse_args(sys.argv[1:] if argv is None else argv)
    return launch(a.nproc, a.module, a.args)


if __name__ == "__main__":
    raise SystemExit(main())
