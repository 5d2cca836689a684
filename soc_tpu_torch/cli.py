"""Command-line entry points of the port.

  python -m soc_tpu_torch rt soc.ini [--device D] [--lanes N]
                                        ~  ASOC.py soc.ini
  python -m soc_tpu_torch pipeline soc.ini [--device D] [--lanes N]
                                        ~  ASOC_driver.py soc.ini

--device is a torch device name (default 'cuda'); pass '--device cpu' to
run on the CPU. soc_tpu's other verbs (sca, a2e_pre, a2e, eqsolve,
a2e_lib, mabu, dust, bench, sampleini) are not ported yet: see ROADMAP.md.
"""

import argparse
import sys

_VERBS_ITEM = "queue item 7 (surrogates, pipeline modes and the other verbs)"
_LATER = {
    "sca": "queue item 6 (scattered light)",
    "a2e_pre": _VERBS_ITEM, "a2e": _VERBS_ITEM, "eqsolve": _VERBS_ITEM,
    "mabu": _VERBS_ITEM, "a2e_lib": _VERBS_ITEM, "dust": _VERBS_ITEM,
    "sampleini": _VERBS_ITEM,
    "bench": "the benchmark, " + _VERBS_ITEM,
}


def _parse(argv):
    ap = argparse.ArgumentParser(prog="python -m soc_tpu_torch")
    ap.add_argument("verb")
    ap.add_argument("ini")
    ap.add_argument("mode", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=None)
    return ap.parse_args(argv)


def main(argv=None, results=None):
    """Run one verb; returns the exit code. ``results``, a dict if given,
    receives the verb's RunResult objects ('rt'; 'absorption', 'emitted'
    and 'map' for the pipeline) for callers that check them."""
    argv = sys.argv[1:] if argv is None else list(argv)
    results = {} if results is None else results
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 1
    if argv[0] in _LATER:
        print("soc_tpu_torch: verb %r is not ported yet (ROADMAP.md: %s); "
              "use python -m soc_tpu %s" % (argv[0], _LATER[argv[0]],
                                            argv[0]), file=sys.stderr)
        return 2
    if argv[0] not in ("rt", "pipeline"):
        print(__doc__)
        return 1
    args = _parse(argv)
    import torch
    from .pipeline import driver
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("soc_tpu_torch: no CUDA device; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        return 2
    lanes = args.lanes or driver.DEFAULT_LANES
    if args.verb == "rt":
        if args.mode is not None:
            print("rt takes one ini file", file=sys.stderr)
            return 1
        res = results["rt"] = driver.run(args.ini, device=device,
                                         lanes=lanes)
        print("soc_tpu_torch rt done: cells=%d timings=%s"
              % (res.grid.cells,
                 {k: round(v, 3) for k, v in res.timings.items()}))
        return 0
    from .pipeline.full import run_pipeline
    res_rt, emitted, res_map = run_pipeline(args.ini, device=device,
                                            lanes=lanes, mode=args.mode)
    results.update(absorption=res_rt, emitted=emitted, map=res_map)
    print("soc_tpu_torch pipeline done: cells=%d absorption=%s maps=%s"
          % (res_rt.grid.cells,
             {k: round(v, 3) for k, v in res_rt.timings.items()},
             {k: round(v, 3) for k, v in res_map.timings.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
