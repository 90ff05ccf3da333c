#!/usr/bin/env python3
"""How often the port's first generator forward on the CPU comes out in
another bit pattern, over fresh processes, per MKL reproducibility mode;
and what each mode costs the CPU path's matmuls.

    python tools/torch_cpu_drift.py [--rounds 20] [--concurrent 3] [--threads 2]
                                    [--mode default --mode AUTO_STRICT ...] [--out F]
    python tools/torch_cpu_drift.py --pipeline 20 [--checkpoint CK] [--mode ...]
                                    [--parallel 1] [--package port|jax] [--out F]
    python tools/torch_cpu_drift.py --bench 5 [--threads 2] [--out F]

Each fresh process builds the ``mtss_wgan_gp_prod`` trainer on the
committed panel (``results/rederived_cleaned``, W=168, Keras-default
weights from its seed) on the CPU, runs the first generator forward of
``generate_block(0, 10)`` and prints the digest of the first LSTM's
output, the layer where the drift shows.  A round starts ``--concurrent``
processes of each mode at once, so the machine is loaded as a pipeline's
members load it.  Modes (``--mode``, repeatable; all by default):
``default`` (``MKL_CBWR`` empty: MKL's default, no reproducibility),
``AUTO``, ``AUTO_STRICT`` (``AUTO,STRICT``, what the port sets at import)
and ``COMPATIBLE``.  Prints, per mode, each digest and how many processes
gave it; ``--out`` also writes the counts as JSON.

``--pipeline N`` instead reruns the original symptom: the ``pipeline``
verb on the CPU (one generator actor and two consumers, ``--blocks 2
--epochs 4``, from a W=168 checkpoint that ``train-gan --epochs 2``
makes first, or ``--checkpoint``) N times a mode, the modes alternated,
``--parallel`` runs at once, and counts the patterns of its items'
digests (one an item).  Each run also digests every stage of every item
inside the members: the block as the generator actor puts it on the
spool (``block``), the arrays as a consumer claims them (``claimed``),
the augmented training set (``augmented``), each sweep lane's training
losses (``lanes``) and the published files (``result``); and which
consumer swept each item as its how-manieth (``order_by_result``).
``--package jax`` runs the JAX package's own ``pipeline`` verb (and its
``train-gan`` for the checkpoint) on the same payload instead, on its CPU
backend with no compilation cache, the same stages digested in its
members.  With ``--out`` the JSON is rewritten after every batch of
runs, so a run stopped by a time limit keeps what it counted.  The JSON then
counts the patterns of each stage, and for every run whose result is not
the most common one names the first stage at which it left the most
common run.  The stage hooks ride in the members through the spawn
start method, which imports this script in each member as
``__mp_main__``.

``--bench N`` instead times, in one fresh process a mode, alternated N
times with nothing else running: 20 first-LSTM forwards of the generator
(B=10, W=168, F=36) and 50 of each GEMM at the sweep's shapes.  Prints
each mode's median seconds per op.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import platform
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {"default": "", "AUTO": "AUTO", "AUTO_STRICT": "AUTO,STRICT",
         "COMPATIBLE": "COMPATIBLE"}
#: the sweep's GEMMs: (m, k) @ (k, n)
SWEEP_GEMMS = ((1848, 22, 21), (22, 1848, 21), (64, 1848, 22), (100, 1848, 100))
#: the file the members append their stage digests to (one JSON line a stage)
DIGEST_ENV = "TORCH_CPU_DRIFT_DIGESTS"
#: the package whose pipeline the members run (``--package``)
PACKAGE_ENV = "TORCH_CPU_DRIFT_PACKAGE"
PACKAGES = {"port": "hfrep_tpu_torch", "jax": "hfrep_tpu"}
#: the pipeline's stages in the order an item passes them
STAGES = ("block", "claimed", "augmented", "lanes", "result")


def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = a.detach().cpu().numpy() if hasattr(a, "detach") else __import__("numpy").asarray(a)
        h.update(str(a.dtype).encode() + str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:8]


def _record(stage: str, item: str, digest: str) -> None:
    line = json.dumps({"stage": stage, "item": item, "digest": digest}) + "\n"
    fd = os.open(os.environ[DIGEST_ENV], os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        os.write(fd, line.encode())
    finally:
        os.close(fd)


def _pin_jax_cpu() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")


def _install_stage_hooks() -> None:
    """Wrap the spool's ``put``, the consumer and the sweep so that each
    stage of an item is digested where it happens (see the docstring)."""
    import importlib

    sys.path.insert(0, ROOT)
    pkg = os.environ.get(PACKAGE_ENV) or PACKAGES["port"]
    if pkg == PACKAGES["jax"]:
        _pin_jax_cpu()
    augment = importlib.import_module(f"{pkg}.experiments.augment")
    sweep = importlib.import_module(f"{pkg}.experiments.sweep")
    actors = importlib.import_module(f"{pkg}.orchestrate.actors")
    queue = importlib.import_module(f"{pkg}.orchestrate.queue")

    put = queue.SpoolQueue.put

    def put_digested(self, source, seq, arrays, *a, **kw):
        _record("block", f"{source}_{seq:05d}", _digest(*(arrays[k] for k in sorted(arrays))))
        return put(self, source, seq, arrays, *a, **kw)

    queue.SpoolQueue.put = put_digested
    current = {}
    make_consumer = actors._make_consumer

    def make_consumer_digested(payload):
        consume = make_consumer(payload)
        sources = list(payload["sources"])

        def consume_digested(source_idx, seq, arrays, tmp_dir):
            current["item"] = f"{sources[source_idx]}_{seq:05d}"
            current["nth"] = current.get("nth", 0) + 1
            _record("order", current["item"], f"{os.getpid()}#{current['nth']}")
            _record("claimed", current["item"],
                    _digest(*(arrays[k] for k in sorted(arrays))))
            return consume(source_idx, seq, arrays, tmp_dir)
        return consume_digested

    actors._make_consumer = make_consumer_digested
    augment_set, run_sweep = augment.augment_training_set, sweep.run_sweep

    def augment_digested(*a, **kw):
        x, y = augment_set(*a, **kw)
        _record("augmented", current["item"], _digest(x, y))
        return x, y

    def run_sweep_digested(*a, **kw):
        res = run_sweep(*a, **kw)
        _record("lanes", current["item"],
                ",".join(_digest(row) for row in res.train_loss))
        return res

    augment.augment_training_set = augment_digested
    sweep.run_sweep = run_sweep_digested


if __name__ == "__mp_main__" and os.environ.get(DIGEST_ENV):
    _install_stage_hooks()


def _first_lstm(torch):
    sys.path.insert(0, ROOT)
    from hfrep_tpu_torch.experiments.cli import _make_trainer
    from hfrep_tpu_torch.train.trainer import seed_mix

    tr, _ = _make_trainer("mtss_wgan_gp_prod", os.path.join(ROOT, "results/rederived_cleaned"),
                          quiet=True, device="cpu")
    g = torch.Generator()
    g.manual_seed(seed_mix(0, 0))
    return tr.state.generator.lstm0, torch.randn((10, 168, 36), generator=g)


def child() -> None:
    import torch

    lstm0, z = _first_lstm(torch)
    with torch.no_grad():
        h = lstm0(z)
    print(hashlib.sha256(h.numpy().tobytes()).hexdigest()[:12])


def bench_child() -> None:
    import torch

    lstm0, z = _first_lstm(torch)
    from hfrep_tpu_torch.obs.timeline import clock
    g = torch.Generator()
    g.manual_seed(1)
    gemms = [(torch.randn((m, k), generator=g), torch.randn((k, n), generator=g))
             for m, k, n in SWEEP_GEMMS]
    out = {}
    with torch.no_grad():
        lstm0(z)
        t0 = clock()
        for _ in range(20):
            lstm0(z)
        out["lstm0 (10,168,36)"] = (clock() - t0) / 20
        for (m, k, n), (a, b) in zip(SWEEP_GEMMS, gemms):
            a @ b
            t0 = clock()
            for _ in range(50):
                a @ b
            out[f"gemm ({m},{k})x({k},{n})"] = (clock() - t0) / 50
    print(json.dumps(out))


def _env(mode: str, threads: int) -> dict:
    return dict(os.environ, MKL_CBWR=MODES[mode], OMP_NUM_THREADS=str(threads))


def _host() -> dict:
    import torch
    return {"machine": platform.machine(), "cpus": os.cpu_count(), "torch": torch.__version__,
            "blas": torch.backends.mkl.is_available() and "mkl"}


def count(args, modes) -> dict:
    counts = {m: collections.Counter() for m in modes}
    for r in range(args.rounds):
        procs = []
        for mode in modes:
            procs += [(mode, subprocess.Popen([sys.executable, __file__, "--child"],
                                              env=_env(mode, args.threads),
                                              stdout=subprocess.PIPE, text=True))
                      for _ in range(args.concurrent)]
        for mode, p in procs:
            out, _ = p.communicate()
            counts[mode][out.strip() or f"exit {p.returncode}"] += 1
        print(f"round {r + 1}/{args.rounds}: " + "; ".join(
            f"{m} {dict(c)}" for m, c in counts.items()), flush=True)
    for mode, c in counts.items():
        print(f"{mode}: {sum(c.values())} processes, {len(c)} pattern(s): {dict(c)}")
    return {"rounds": args.rounds, "concurrent": args.concurrent, "threads": args.threads,
            "host": _host(), "counts": {m: dict(c) for m, c in counts.items()}}


def _verb(argv, env) -> subprocess.CompletedProcess:
    pkg = env.get(PACKAGE_ENV) or PACKAGES["port"]
    return subprocess.run([sys.executable, "-m", pkg] + argv, cwd=ROOT, env=env,
                          capture_output=True, text=True, check=True)


def pipeline_child(argv) -> int:
    """The ``pipeline`` verb with the stage hooks in this process and, by
    the spawn start method, in every member it starts."""
    import importlib

    _install_stage_hooks()
    pkg = os.environ.get(PACKAGE_ENV) or PACKAGES["port"]
    return importlib.import_module(f"{pkg}.experiments.cli").main(argv)


def _stages(digest_file: str, out_dir: str) -> dict:
    """``{stage: "item=digest ..."}`` for one run, items in order; a stage
    seen twice for an item (a duplicate delivery) keeps every digest."""
    seen = collections.defaultdict(lambda: collections.defaultdict(list))
    with open(digest_file) as f:
        for line in f:
            r = json.loads(line)
            seen[r["stage"]][r["item"]].append(r["digest"])
    out = {st: " ".join(f"{it}={'/'.join(d)}" for it, d in sorted(seen[st].items()))
           for st in STAGES[:-1]}
    out["result"] = _items_digest(out_dir)
    # which consumer swept each item, and as its how-manieth: consumers
    # named c0, c1, ... in the order of the items they took first
    pids = {}
    order = []
    for it, d in sorted(seen["order"].items()):
        for x in d:
            pid, nth = x.split("#")
            order.append(f"{it}=c{pids.setdefault(pid, len(pids))}#{nth}")
    out["order"] = " ".join(order)
    return out


def _first_departures(runs: list) -> dict:
    """For each run whose result is not the most common one, the first
    stage at which it differs from a run of the most common result."""
    common = collections.Counter(r["result"] for r in runs).most_common(1)[0][0]
    ref = next(r for r in runs if r["result"] == common)
    out = collections.Counter()
    for r in runs:
        if r["result"] != common:
            out[next((st for st in STAGES if r[st] != ref[st]), "none")] += 1
    return dict(out)


def _items_digest(out_dir: str) -> str:
    """``item=digest`` for each item's array and CSV files, in item order."""
    results = os.path.join(out_dir, "results")
    out = []
    for item in sorted(os.listdir(results)):
        path = os.path.join(results, item)
        if not os.path.isdir(path):
            continue
        h = hashlib.sha256()
        for name in sorted(os.listdir(path)):
            if name.endswith((".npy", ".npz", ".csv")):
                h.update(name.encode())
                with open(os.path.join(path, name), "rb") as f:
                    h.update(f.read())
        out.append(f"{item}={h.hexdigest()[:8]}")
    return " ".join(out)


def pipeline(args, modes) -> dict:
    import shutil
    import tempfile

    env_base = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS=str(args.threads),
                    **{PACKAGE_ENV: PACKAGES[args.package]})
    device = ["--device", "cpu"]
    if args.package == "jax":
        # the JAX CLI pins its backend from HFREP_PLATFORM; no persistent
        # compilation cache, so every run compiles as a fresh process
        env_base.update(HFREP_PLATFORM="cpu", JAX_PLATFORMS="cpu", HFREP_COMPILATION_CACHE="")
        device = []
    cleaned = os.path.join(ROOT, "results/rederived_cleaned")
    counts = {m: collections.Counter() for m in modes}
    runs = {m: [] for m in modes}
    with tempfile.TemporaryDirectory() as tmp:
        ck = args.checkpoint
        if ck is None:
            _verb(["train-gan", *device, "--preset", "mtss_wgan_gp_prod", "--epochs",
                   "2", "--cleaned-dir", cleaned, "--checkpoint-dir", os.path.join(tmp, "ck"),
                   "--quiet"], env_base)
            ck = os.path.join(tmp, "ck", "ckpt_2")
        order = [mode for i in range(args.pipeline) for mode in (modes if i % 2 == 0
                                                                  else modes[::-1])]
        for start in range(0, len(order), args.parallel):
            procs = []
            for slot, mode in enumerate(order[start:start + args.parallel]):
                out = os.path.join(tmp, f"pl{slot}")
                digests = os.path.join(tmp, f"digests{slot}.jsonl")
                shutil.rmtree(out, ignore_errors=True)
                if os.path.exists(digests):
                    os.remove(digests)
                argv = ["pipeline", *device, "--gan-checkpoint", ck, "--preset",
                        "mtss_wgan_gp_prod", "--cleaned-dir", cleaned, "--blocks", "2",
                        "--consumers", "2", "--epochs", "4", "--out", out]
                env = dict(env_base, MKL_CBWR=MODES[mode], **{DIGEST_ENV: digests})
                procs.append((mode, out, digests, subprocess.Popen(
                    [sys.executable, __file__, "--pipeline-child", "--"] + argv, cwd=ROOT,
                    env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)))
            for mode, out, digests, p in procs:
                _, err = p.communicate()
                if p.returncode != 0:
                    raise SystemExit(f"pipeline run exited {p.returncode}:\n{err[-4000:]}")
                stages = _stages(digests, out)
                runs[mode].append(stages)
                counts[mode][stages["result"]] += 1
            print(f"runs {start + len(procs)}/{len(order)}: " + "; ".join(
                f"{m} {dict(c)}" for m, c in counts.items()), flush=True)
            _write(args.out, _pipeline_doc(args, modes, counts, runs))
    for mode, c in counts.items():
        print(f"{mode}: {sum(c.values())} pipeline runs, {len(c)} pattern(s): {dict(c)}")
        print(f"{mode}: first stage that differs: {_first_departures(runs[mode])}")
    return _pipeline_doc(args, modes, counts, runs)


def _pipeline_doc(args, modes, counts, runs) -> dict:
    done = {m: runs[m] for m in modes if runs[m]}
    return {"pipeline_runs": args.pipeline, "parallel": args.parallel,
            "threads": args.threads, "package": args.package, "host": _host(),
            "runs_done": sum(len(r) for r in runs.values()),
            "counts": {m: dict(c) for m, c in counts.items()},
            "stage_counts": {m: {st: dict(collections.Counter(r[st] for r in done[m]))
                                 for st in STAGES} for m in done},
            "first_departure": {m: _first_departures(done[m]) for m in done},
            "order_by_result": {m: dict(collections.Counter(f"{r['order']} -> {r['result']}"
                                                            for r in done[m])) for m in done}}


def _write(path, doc: dict) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")


def bench(args, modes) -> dict:
    runs = {m: collections.defaultdict(list) for m in modes}
    for i in range(args.bench):
        for mode in (modes if i % 2 == 0 else modes[::-1]):
            out = subprocess.run([sys.executable, __file__, "--bench-child"],
                                 env=_env(mode, args.threads), capture_output=True, text=True,
                                 check=True).stdout
            for op, s in json.loads(out.splitlines()[-1]).items():
                runs[mode][op].append(s)
    med = {m: {op: statistics.median(v) for op, v in ops.items()} for m, ops in runs.items()}
    for op in med[modes[0]]:
        print(f"{op}: " + "; ".join(f"{m} {med[m][op] * 1e3:.4f} ms" for m in modes))
    return {"alternations": args.bench, "threads": args.threads, "host": _host(),
            "median_s": med, "runs_s": {m: dict(ops) for m, ops in runs.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--concurrent", type=int, default=3)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--mode", action="append", choices=sorted(MODES))
    ap.add_argument("--pipeline", type=int, default=0, metavar="N")
    ap.add_argument("--checkpoint", default=None, help="the pipeline's W=168 checkpoint")
    ap.add_argument("--parallel", type=int, default=1, help="pipeline runs at once")
    ap.add_argument("--package", choices=sorted(PACKAGES), default="port",
                    help="whose pipeline verb --pipeline runs")
    ap.add_argument("--bench", type=int, default=0, metavar="N")
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--bench-child", action="store_true", help=argparse.SUPPRESS)
    if sys.argv[1:2] == ["--pipeline-child"]:
        sys.exit(pipeline_child(sys.argv[3:]))
    args = ap.parse_args()
    if args.child:
        child()
        return
    if args.bench_child:
        bench_child()
        return
    modes = args.mode or list(MODES)
    doc = (pipeline(args, modes) if args.pipeline else bench(args, modes) if args.bench
           else count(args, modes))
    _write(args.out, doc)


if __name__ == "__main__":
    main()
