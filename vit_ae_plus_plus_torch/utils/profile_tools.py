"""Step-time attribution from a torch.profiler trace.

The port's copy of the JAX package's utils/profile_tools.py. The reference's
only observability is timing meters and max memory (utils/misc.py:129-156);
this module turns the trace that `pretrain-kfold --profile-dir` writes (one
steady epoch of a fold, `fold_{k}_epoch_{e}.json`, torch.profiler's Chrome
JSON) into the named-bucket table of a step's device time (attention
kernels / matmul fusions / LN reductions / copies / ...), the JAX
package's buckets in its order.

Usage:
    python -m vit_ae_plus_plus_torch.cli profile-attrib --trace-dir DIR --steps N

Parsing: the device's work is the complete ("ph": "X") events of category
`kernel`, `gpu_memcpy` and `gpu_memset`, summed by name; the host's
`cuda_runtime` calls and the flow events are skipped. A trace with no
device events (one taken on the CPU) falls back to its `cpu_op` events, as
the JAX package falls back to all lines of a CPU trace.
"""

from __future__ import annotations

import glob
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# (bucket, patterns searched in the op name); the first hit wins, so the
# order goes from the most specific. The names are the port's trace's:
# its kernels `flash_*` (kernels/csrc/flash_*.cu), `vitae_lnd_*`
# (ln_dense.cu), `vitae_ln*` (layernorm.cu), cuBLAS's gemm / cutlass /
# sm90_xmma / nvjet kernels, cuDNN's convolutions, NCCL's collectives, and
# the Memcpy / Memset device events
_BUCKET_RULES: List[Tuple[str, Tuple[str, ...]]] = [
    ("attention kernels", (r"\bflash_",)),
    ("matmul fusions", (r"\bvitae_lnd_",)),
    ("LN reductions", (r"\bvitae_ln", r"layer_norm")),
    ("copies/layout", (r"^memcpy", r"^memset", r"copy", r"transpose")),
    ("convolutions", (r"cudnn", r"convol", r"conv[_\d]", r"fprop", r"dgrad", r"wgrad")),
    ("matmul fusions", (r"gemm", r"cutlass", r"sm90_xmma", r"nvjet")),
    ("collectives", (r"nccl",)),
]
_COMPILED = [(bucket, [re.compile(p) for p in pats]) for bucket, pats in _BUCKET_RULES]


def find_trace_files(trace_dir: str) -> List[str]:
    """The newest trace (by modification time) under `trace_dir`, as a
    one-element list; `trace_dir` may itself be a trace file."""
    if os.path.isfile(trace_dir):
        return [trace_dir]
    files = glob.glob(os.path.join(trace_dir, "*.json")) + glob.glob(os.path.join(trace_dir, "*", "*.json"))
    if not files:
        raise FileNotFoundError(f"no torch.profiler trace (*.json) under {trace_dir}")
    return [max(files, key=lambda f: (os.path.getmtime(f), f))]


def parse_trace(path: str, categories=DEVICE_CATEGORIES) -> Dict[str, Tuple[float, int]]:
    """Sum per-op-name (total_ms, occurrences) over the complete events of
    `categories`; with none there, over the trace's `cpu_op` events."""
    with open(path) as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    ops: Dict[str, Tuple[float, int]] = defaultdict(lambda: (0.0, 0))
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in categories:
            continue
        t, c = ops[ev.get("name", "?")]
        ops[ev.get("name", "?")] = (t + float(ev.get("dur", 0.0)) / 1e3, c + 1)
    if not ops and tuple(categories) != ("cpu_op",):
        return parse_trace(path, ("cpu_op",))
    return dict(ops)


def bucket_of(op_name: str) -> str:
    low = op_name.lower()
    if low.startswith("void "):
        low = low[5:]
    for bucket, needles in _COMPILED:
        if any(n.search(low) for n in needles):
            return bucket
    return "misc"


def attribute(ops: Dict[str, Tuple[float, int]], steps: int = 1,
              top_k: int = 8) -> Dict[str, dict]:
    """Fold per-op totals into the bucket table.

    Returns {bucket: {"ms_per_step", "pct", "top_ops": [(name, ms/step), ...]}}
    plus a "__total__" entry."""
    per_bucket_ms: Dict[str, float] = defaultdict(float)
    per_bucket_ops: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
    for name, (ms, _count) in ops.items():
        b = bucket_of(name)
        per_bucket_ms[b] += ms / steps
        per_bucket_ops[b][name] += ms / steps
    total = sum(per_bucket_ms.values())
    out = {}
    for b, ms in sorted(per_bucket_ms.items(), key=lambda kv: -kv[1]):
        tops = sorted(per_bucket_ops[b].items(), key=lambda kv: -kv[1])[:top_k]
        out[b] = {
            "ms_per_step": ms,
            "pct": 100.0 * ms / total if total else 0.0,
            "top_ops": tops,
        }
    out["__total__"] = {"ms_per_step": total, "pct": 100.0, "top_ops": []}
    return out


def format_table(table: Dict[str, dict], show_ops: int = 3) -> str:
    lines = [f"{'bucket':<22} {'ms/step':>9} {'%':>6}"]
    for b, row in table.items():
        if b == "__total__":
            continue
        lines.append(f"{b:<22} {row['ms_per_step']:>9.2f} {row['pct']:>5.1f}%")
        for name, ms in row["top_ops"][:show_ops]:
            nm = name if len(name) <= 48 else name[:45] + "..."
            lines.append(f"    {nm:<48} {ms:>7.2f}")
    tot = table["__total__"]["ms_per_step"]
    lines.append(f"{'TOTAL (device busy)':<22} {tot:>9.2f}")
    return "\n".join(lines)


def attribute_trace(trace_dir: str, steps: int = 1) -> Dict[str, dict]:
    """End to end: the newest trace -> its op table -> buckets."""
    merged: Dict[str, Tuple[float, int]] = defaultdict(lambda: (0.0, 0))
    for path in find_trace_files(trace_dir):
        for name, (ms, n) in parse_trace(path).items():
            t, c = merged[name]
            merged[name] = (t + ms, c + n)
    return attribute(dict(merged), steps=steps)
