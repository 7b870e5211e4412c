"""Interactive GQL console for a live graph cluster or a local dump
(copy of euler_tpu/tools/console.py, over the port's engine).

Parity: euler/tools/remote_console/remote_console.cc — the linenoise CLI
that issues gremlin to a running cluster and pretty-prints results.

Usage:
  python -m euler_tpu_torch.tools.console --endpoints hosts:127.0.0.1:9190
  python -m euler_tpu_torch.tools.console --endpoints dir:/srv/registry
  python -m euler_tpu_torch.tools.console --data /path/to/dump      # embedded
  python -m euler_tpu_torch.tools.console --endpoints ... -q 'sampleN(-1, 4).as(n)'

Console commands:
  let <name> u64|i32|f32 <v1,v2,...>   bind an input tensor
  inputs                                list bound inputs
  <gremlin>                             run it (e.g. v(roots).getNB(*).as(nb))
  help | quit
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

_DTYPES = {"u64": np.uint64, "i32": np.int32, "f32": np.float32}


def _print_outputs(out: dict) -> None:
    for name in sorted(out):
        v = out[name]
        with np.printoptions(threshold=40, edgeitems=8):
            print(f"  {name}: {v.dtype}{list(v.shape)} = {v}")


def run_console(query, one_shot: str = "") -> int:
    inputs: dict = {}
    if one_shot:
        try:
            _print_outputs(query.run(one_shot, inputs))
            return 0
        except Exception as e:
            print(f"error: {e}", file=sys.stderr)
            return 1
    try:
        import readline  # noqa: F401  (line editing + history)
    except ImportError:
        pass
    print("euler_tpu console — 'help' for commands, 'quit' to exit")
    while True:
        try:
            line = input("gql> ").strip()
        except (EOFError, KeyboardInterrupt):
            print()
            return 0
        if not line:
            continue
        if line in ("quit", "exit"):
            return 0
        if line == "help":
            print(__doc__)
            continue
        if line == "inputs":
            for k, v in inputs.items():
                print(f"  {k}: {v.dtype}{list(v.shape)}")
            continue
        if line.startswith("let "):
            try:
                _, name, dt, vals = line.split(None, 3)
                inputs[name] = np.array(
                    [float(x) if dt == "f32" else int(x)
                     for x in vals.replace(",", " ").split()],
                    dtype=_DTYPES[dt])
                print(f"  {name}: {inputs[name].dtype}{list(inputs[name].shape)}")
            except (ValueError, KeyError) as e:
                print(f"  bad let (let <name> u64|i32|f32 <v,...>): {e}")
            continue
        try:
            _print_outputs(query.run(line, inputs))
        except Exception as e:  # engine errors surface as messages
            print(f"  error: {e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--endpoints", default="",
                    help="hosts:h:p,... or dir:/registry (remote mode)")
    ap.add_argument("--mode", default="distribute",
                    choices=["distribute", "graph_partition"])
    ap.add_argument("--data", default="", help="local dump dir (embedded mode)")
    ap.add_argument("--index", default="", help="index spec for embedded mode")
    ap.add_argument("-q", "--query", default="", help="run one query and exit")
    args = ap.parse_args(argv)

    from euler_tpu_torch.gql import Query

    if args.endpoints:
        q = Query.remote(args.endpoints, mode=args.mode)
    elif args.data:
        from euler_tpu_torch.graph import GraphEngine

        engine = GraphEngine.load(args.data)
        q = Query.local(engine, index_spec=args.index)
    else:
        ap.error("need --endpoints or --data")
    try:
        return run_console(q, args.query)
    finally:
        q.close()


if __name__ == "__main__":
    sys.exit(main())
