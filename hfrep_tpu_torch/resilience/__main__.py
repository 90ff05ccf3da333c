"""``python -m hfrep_tpu_torch.resilience``: the resilience CLI
(``hfrep_tpu/resilience/__main__.py``).

    selftest        the scripted kill→resume and chaos-scenario gate
                    (selftest.py) on ``--device``
    chaos           property-based fault-schedule search: seeded random
                    schedules over the fault registries, driven through
                    real subjects in subprocesses on ``--device``, judged
                    by the shared oracles, failures shrunk to minimal
                    HFREP_FAULTS specs; --replay-corpus replays the
                    committed corpus (chaos.py)
    chaos-subject   internal: one subject run in this process (the chaos
                    driver's spawn target; exit 0 complete / 75 drained)
    explain-faults  a parsed HFREP_FAULTS spec as a table: kind, site,
                    counter group, occurrence, count, effect
    drives          every registered DriveSpec and its envelope
                    capabilities (drive.py); --check runs the registry
                    completeness gate (fixtures resolve, fault sites
                    known, six families covered, the registry and the
                    chaos subjects mirror each other, every JAX spec
                    registered or named as a gap)
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from hfrep_tpu_torch.obs import timeline


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hfrep_tpu_torch.resilience",
                                 description="fault injection and recovery subsystem CLI")
    sub = ap.add_subparsers(dest="cmd", required=True)
    st_p = sub.add_parser("selftest",
                          help="drive kill→resume and corrupt→fallback end to end and assert "
                               "bit-identical recovery (the JAX package's fixture shapes)")
    st_p.add_argument("--device", default="cuda",
                      help="where every scenario runs (default: the card)")

    chaos_p = sub.add_parser(
        "chaos", help="seeded property-based fault-schedule search with shrinking and corpus "
                      "replay (exit 1 on any invariant violation)")
    from hfrep_tpu_torch.resilience.chaos import add_chaos_args
    add_chaos_args(chaos_p)

    subj_p = sub.add_parser(
        "chaos-subject", help="internal: run ONE chaos subject in this process (the driver "
                              "spawns these; HFREP_FAULTS arms the schedule)")
    subj_p.add_argument("name")
    subj_p.add_argument("--out", required=True)
    subj_p.add_argument("--fixture-seed", type=int, default=0)
    subj_p.add_argument("--resume", action="store_true")
    subj_p.add_argument("--device", default="cuda",
                        help="where the subject's tensors live (default: the card)")

    drv_p = sub.add_parser(
        "drives", help="list registered DriveSpecs and their envelope capabilities; --check "
                       "gates registry completeness (exit 1 on a hole)")
    drv_p.add_argument("--format", choices=("human", "json"), default="human")
    drv_p.add_argument("--check", action="store_true",
                       help="run the completeness gate instead of just listing")

    exp_p = sub.add_parser(
        "explain-faults", help="pretty-print a parsed HFREP_FAULTS spec (unknown sites error "
                               "with the registry's nearest candidates)")
    exp_p.add_argument("spec")
    exp_p.add_argument("--format", choices=("human", "json"), default="human")

    args = ap.parse_args(argv)

    if args.cmd == "selftest":
        from hfrep_tpu_torch.resilience.selftest import run_selftest
        t0 = timeline.clock()
        try:
            doc = run_selftest(device=args.device)
        except Exception as e:
            print(json.dumps({"selftest": "FAIL", "error": f"{type(e).__name__}: {e}"}))
            return 1
        doc["selftest"] = "ok"
        doc["secs"] = round(timeline.clock() - t0, 2)
        print(json.dumps(doc))
        return 0

    if args.cmd == "chaos":
        from hfrep_tpu_torch.resilience.chaos import run_chaos
        return run_chaos(args)

    if args.cmd == "chaos-subject":
        from hfrep_tpu_torch.resilience.chaos_subjects import subject_main
        return subject_main(args.name, args.out, args.fixture_seed, args.resume,
                            device=args.device)

    if args.cmd == "drives":
        from hfrep_tpu_torch.resilience.drive import (
            DRIVE_REGISTRY,
            check_registry,
            spec_capabilities,
        )
        rows = [spec_capabilities(s) for s in DRIVE_REGISTRY.values()]
        ok, problems = (check_registry() if args.check else (True, []))
        if args.format == "json":
            print(json.dumps({"drives": rows, "ok": ok, "problems": problems}, indent=2,
                             sort_keys=True))
        else:
            for r in rows:
                caps = [r["snapshot"] if r["snapshot"] != "none" else "",
                        "deterministic" if r["deterministic"] else "",
                        "resumable" if r["resumable"] else "",
                        "double-buffer" if r["double_buffer"] else ""]
                print(f"{r['name']:<14} {r['family']:<12} tier={r['tier']:<5} "
                      f"sites={','.join(r['boundary_sites']) or '-':<28} "
                      f"{' '.join(c for c in caps if c)}")
            for p in problems:
                print(f"PROBLEM: {p}", file=sys.stderr)
            if args.check:
                print(f"drives: {len(rows)} specs, "
                      f"{'ok' if ok else f'{len(problems)} problem(s)'}", file=sys.stderr)
        return 0 if ok else 1

    # explain-faults
    from hfrep_tpu_torch.resilience.faults import (
        FaultPlan,
        FaultSpecError,
        plan_rows,
        render_plan,
    )
    try:
        plan = FaultPlan.parse(args.spec)
    except FaultSpecError as e:
        print(f"explain-faults: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps({"spec": plan.spec(), "directives": plan_rows(plan)}, sort_keys=True))
    else:
        print(render_plan(plan))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
