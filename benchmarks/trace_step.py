#!/usr/bin/env python
"""Profile the fused 1M rebuild + self-contact step on one GPU and reduce
the trace to device time per operation.

    python benchmarks/trace_step.py [--out chiprun_out/trace_step]

Prints the window's device busy time and idle share, the device time of
each pipeline stage, and the operations with the most device time.  An
operation's stage is the ``jax.named_scope`` (build, tiles/phase1,
tiles/count, tiles/emit, tiles/finish) in the op_name metadata that the
compiled HLO gives the instruction of the same name.  Exits non-zero when
JAX finds no GPU.
"""

import collections
import glob
import os
import re
import sys

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench import N_TRI, make_step, synth_triangles  # noqa: E402
from implicitbvh_tpu.utils import use_compile_cache  # noqa: E402

STAGES = ("tiles/phase1", "tiles/count", "tiles/emit", "tiles/finish",
          "build")
# Pallas kernels appear in the trace under their own name
KERNELS = {"band_row_counts": "tiles/count"}


def op_scopes(hlo_text):
    """HLO instruction name -> its op_name metadata; a fusion without
    metadata takes the first op_name inside the computation it calls."""
    inst = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = ([^\n]*)$', re.M)
    comp = re.compile(r'^%?([\w.\-]+) [^\n]*\{\s*$', re.M)
    opn = re.compile(r'op_name="([^"]*)"')
    calls = re.compile(r'calls=%?([\w.\-]+)')
    scopes, called, comp_scope = {}, {}, {}
    current = None
    for line in hlo_text.splitlines():
        m = comp.match(line)
        if m and " = " not in line:
            current = m.group(1)
            continue
        m = inst.match(line)
        if not m:
            continue
        name, rest = m.groups()
        o = opn.search(rest)
        if o:
            scopes[name] = o.group(1)
            comp_scope.setdefault(current, o.group(1))
        c = calls.search(rest)
        if c:
            called[name] = c.group(1)
    for name, target in called.items():
        if name not in scopes and target in comp_scope:
            scopes[name] = comp_scope[target]
    return scopes


def scope_of_event(name, scopes):
    """An event's op_name: by instruction name, without the ``__N``
    suffix the runtime gives split kernels, or by Pallas kernel name."""
    base = re.sub(r"__\d+$", "", name)
    return scopes.get(name) or scopes.get(base) or KERNELS.get(base, "")


def device_events(path, scopes):
    """(name, scope, start_ns, dur_ns) of every op event on GPU planes."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # kernel launches live on the stream lines; skip the derived
            # per-module / per-op summary lines to avoid double counting
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                out.append((ev.name, scope_of_event(ev.name, scopes),
                            ev.start_ns, ev.duration_ns))
    return out


def busy_ns(events):
    spans = sorted((s, s + d) for _, _, s, d in events)
    total, end = 0, None
    for s, e in spans:
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, spans[0][0], max(e for _, e in spans)


def main():
    use_compile_cache()
    if jax.devices()[0].platform != "gpu":
        sys.exit("trace_step.py needs a GPU")
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else "chiprun_out/trace_step"
    tri = synth_triangles(N_TRI)
    step = make_step(N_TRI)
    scopes = op_scopes(step.lower(*tri).compile().as_text())
    for _ in range(3):
        jax.block_until_ready(step(*tri))
    with jax.profiler.trace(out):
        for _ in range(3):
            jax.block_until_ready(step(*tri))
    path = sorted(glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    ev = device_events(path, scopes)
    busy, t0, t1 = busy_ns(ev)
    print(f"window {(t1 - t0) / 3e6:.3f} ms/step, device busy "
          f"{busy / 3e6:.3f} ms/step, idle share {1 - busy / (t1 - t0):.3f}")
    by_stage = collections.Counter()
    by_op = collections.Counter()
    scope_of = {}
    for name, scope, _, d in ev:
        stage = next((s for s in STAGES if s in scope), "other")
        by_stage[stage] += d
        by_op[name] += d
        scope_of[name] = scope
    for stage, d in by_stage.most_common():
        print(f"  stage {stage:14s} {d / 3e6:9.3f} ms/step "
              f"({d / busy:.1%} of busy)")
    for name, d in by_op.most_common(20):
        print(f"  op {d / 3e6:9.3f} ms/step  {name}  [{scope_of[name][:90]}]")


if __name__ == "__main__":
    main()
