"""Per-file clock of a tier-1 run: seconds, tests and XLA compiles.

Run the tier-1 command with compile logging on and the captured logs kept
in its JUnit file, then read that file::

    JAX_LOG_COMPILES=1 python -m pytest tests/ -q -m 'not slow' \\
        -p xdist -n 6 --dist loadfile --junitxml=run.xml \\
        -o junit_logging=log --durations=0
    python scripts/tier1_clock.py run.xml

For each test file it prints the tests run and passed, the seconds its
tests took (set-up, call and tear-down; under ``--dist loadfile`` a file
runs on one worker, so this is its wall time there), the XLA compiles its
tests logged and their seconds (in a ``test_torch_*`` file every compile
is the reference's: the port compiles nothing), the seconds JAX spent
tracing and lowering to MLIR, and its most expensive compiled program.
Files are listed by seconds, longest first; the totals close the table.
"""
import argparse
import re
import sys
import xml.etree.ElementTree as ET
from collections import defaultdict

COMPILE = re.compile(r"Finished XLA compilation of (.+?) in ([0-9.eE+-]+) sec")
TRACE = re.compile(r"Finished tracing \+ transforming (.+?) for \w+ in "
                   r"([0-9.eE+-]+) sec")
LOWER = re.compile(r"Finished jaxpr to MLIR module conversion (.+?) in "
                   r"([0-9.eE+-]+) sec")


def file_of(case):
    """The test file of a JUnit ``testcase``: its ``file`` attribute, or
    its ``classname`` (``tests.test_x`` or ``tests.test_x.TestY``)."""
    if case.get("file"):
        return case.get("file")
    parts = case.get("classname", "").split(".")
    for i in range(len(parts), 0, -1):
        if parts[i - 1].startswith("test_"):
            return "/".join(parts[:i]) + ".py"
    return case.get("classname", "?")


def clock(path):
    rows = defaultdict(lambda: dict(
        tests=0, passed=0, seconds=0.0, compiles=0, compile_s=0.0,
        trace_s=0.0, lower_s=0.0, programs=defaultdict(float)))
    for case in ET.parse(path).getroot().iter("testcase"):
        r = rows[file_of(case)]
        r["tests"] += 1
        bad = any(case.find(t) is not None
                  for t in ("failure", "error", "skipped"))
        r["passed"] += not bad
        r["seconds"] += float(case.get("time", 0.0))
        text = "".join(e.text or "" for e in case.iter()
                       if e.tag in ("system-out", "system-err"))
        for name, sec in COMPILE.findall(text):
            r["compiles"] += 1
            r["compile_s"] += float(sec)
            r["programs"][name] += float(sec)
        r["trace_s"] += sum(float(s) for _, s in TRACE.findall(text))
        r["lower_s"] += sum(float(s) for _, s in LOWER.findall(text))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit_xml")
    args = ap.parse_args(argv)
    rows = clock(args.junit_xml)
    order = sorted(rows, key=lambda f: -rows[f]["seconds"])
    print("| file | tests | passed | s | compiles | compile s | trace s "
          "| lower s | costliest program (s) |")
    print("|---|---|---|---|---|---|---|---|---|")
    for f in order:
        r = rows[f]
        top = max(r["programs"].items(), key=lambda kv: kv[1],
                  default=("-", 0.0))
        print(f"| {f} | {r['tests']} | {r['passed']} | {r['seconds']:.1f} "
              f"| {r['compiles']} | {r['compile_s']:.1f} | "
              f"{r['trace_s']:.1f} | {r['lower_s']:.1f} | {top[0]} "
              f"({top[1]:.1f}) |")
    tot = {k: sum(r[k] for r in rows.values())
           for k in ("tests", "passed", "seconds", "compiles", "compile_s",
                     "trace_s", "lower_s")}
    print(f"| all {len(rows)} files | {tot['tests']} | {tot['passed']} | "
          f"{tot['seconds']:.1f} | {tot['compiles']} | "
          f"{tot['compile_s']:.1f} | {tot['trace_s']:.1f} | "
          f"{tot['lower_s']:.1f} | |")


if __name__ == "__main__":
    sys.exit(main())
