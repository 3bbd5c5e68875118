"""N-process run of the port's multi-process paths (counterpart of the JAX
package's ``scripts/bench_multihost.py``).

Spawns ``--nproc`` processes joined through ``multihost.initialize`` (a
file rendezvous in a temporary directory, so no port is taken); each
process is one rank on one device and runs, on the global mesh:

1. the heartbeat (``health.check``);
2. a dp x tp AdamW QAT step with remat (tp 2 when ``--nproc`` is even,
   else 1; dp the rest), each process feeding only its own dp rows of the
   batch (``multihost.host_array``): the losses must agree across
   processes;
3. a tensor-parallel forward with tp spanning every process (a prefill
   and one decode step): logits finite and equal on every rank.

It prints one line per process and ``multihost OK`` or ``multihost
FAILED``, and exits non-zero on a failure.  On the card (the default,
``--device cuda``) each rank takes a GPU of its own with NCCL where there
are as many GPUs as ranks; ranks sharing one GPU run gloo (NCCL refuses
two ranks on one device).  ``--device cpu`` runs gloo on the CPU.

    python -m quant_gemm_tpu_torch.scripts.multihost --nproc 2
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TIMEOUT_S = 300  # each process's limit


def _backend(device: str, nproc: int):
    """(backend, whether each rank has a GPU of its own)."""
    import torch

    if device == "cpu":
        return "gloo", False
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is "
                           "False (pass --device cpu)")
    if torch.cuda.device_count() >= nproc:
        return "nccl", True
    return "gloo", False


def worker(args) -> None:
    import numpy as np
    import torch

    from quant_gemm_tpu_torch.models import llama, llama_tp, train
    from quant_gemm_tpu_torch.parallel import health, multihost, sharding

    backend, own = _backend(args.device, args.nproc)
    multihost.initialize(args.coordinator, args.nproc, args.process_id,
                         local_device_ids=[args.process_id] if own else None,
                         backend=backend, timeout_s=120)
    if args.device == "cuda" and not own:
        torch.cuda.set_device(0)
    pid = args.process_id
    report = health.check(30.0, device=args.device)
    if not report.ok:
        raise RuntimeError(report.row())

    # 2. dp x tp QAT step, per-process data feeding
    tp = 2 if args.nproc % 2 == 0 else 1
    dp = args.nproc // tp
    mesh = multihost.global_mesh({"dp": dp, "tp": tp}, args.device)
    cfg = llama.LlamaConfig(vocab=64 * tp, dim=128 * tp, n_layers=2,
                            n_heads=2 * tp, n_kv_heads=2 * tp,
                            d_ff=128 * tp, max_seq=32)
    params, opt, step = train.make_state_step(
        llama.init_params(cfg, seed=0), cfg, mesh=mesh, optimizer="adamw",
        lr=1e-3, qtype="q4_0", remat=True)
    rng = np.random.default_rng(7)  # the same stream everywhere
    batch = rng.integers(0, cfg.vocab, size=(2 * dp, 16))
    di = mesh.index("dp")
    tokens = multihost.host_array(mesh, batch[2 * di:2 * (di + 1)])
    _, _, loss = step(params, opt, tokens)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"loss {loss}")

    # 3. tp serving over every process
    n = args.nproc
    smesh = multihost.global_mesh({"tp": n}, args.device)
    scfg = llama.LlamaConfig(vocab=64, dim=128 * n, n_layers=2,
                             n_heads=2 * n, n_kv_heads=2 * n, d_ff=128 * n,
                             max_seq=32)  # head_dim 64: flash_decode's
    sparams = llama_tp.shard_params_tp(llama.init_params(scfg, seed=1),
                                       scfg, smesh, "q4_0")
    cache = llama_tp.init_cache_tp(scfg, 2, smesh)
    toks = multihost.replicated(smesh, [[3, 7, 1], [5, 2, 9]])
    logits, cache = llama_tp.forward_tp(sparams, scfg, toks, cache, smesh)
    nxt = torch.argmax(logits[:, -1:], -1)
    logits, cache = llama_tp.forward_tp(sparams, scfg, nxt, cache, smesh)
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("non-finite logits")
    every = sharding.all_gather(logits[None], smesh, "tp", dim=0)
    if not all(torch.equal(every[0], x) for x in every):
        raise RuntimeError("the ranks' logits differ")
    digest = float(logits.abs().sum())
    print(f"[proc {pid}] OK backend={backend} {report.row()} "
          f"loss={loss:.6f} tp-serve|logits|={digest:.4f}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--coordinator", default=None,
                    help="rendezvous URL (default: a file in a temporary "
                         "directory)")
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    if args.process_id is not None:  # worker mode
        worker(args)
        return

    tmp = tempfile.mkdtemp(prefix="qgt_multihost_")
    coordinator = args.coordinator or f"file://{tmp}/store"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "quant_gemm_tpu_torch.scripts.multihost",
         "--nproc", str(args.nproc), "--device", args.device,
         "--coordinator", coordinator, "--process-id", str(i)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(args.nproc)]
    outs, codes = [], []
    try:
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TIMEOUT_S)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n(killed: timed out)")
            codes.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    for i, (o, c) in enumerate(zip(outs, codes)):
        tail = "\n".join(o.strip().splitlines()[-3:])
        print(f"--- process {i} (exit {c}) ---\n{tail}", flush=True)
    losses = {m.group(1) for o in outs
              for m in re.finditer(r"loss=([0-9.eE+-]+)", o)}
    ok = all(c == 0 for c in codes) and len(losses) == 1
    print(f"multihost {'OK' if ok else 'FAILED'}: {args.nproc} processes on "
          f"{args.device}, losses={sorted(losses)}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
