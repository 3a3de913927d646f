"""One run of one cell: set-up, the timed window, the traced sub-window
(``trace``), the check against the reference, and the result line."""

from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from harness import check, kernels
from harness.manifest import Bench
from reference import field as fld


def per_layer_record(cell, win: dict, rec: dict, work: dict) -> dict:
    c = cell.config
    dev = cell.dev
    return {"peak_flops": kernels.peak_flops(torch.cuda.get_device_name(dev))
            if dev.type == "cuda" else None,
            "flops_per_sample": fld.flops_per_sample(c["arch"]),
            "window": {"seconds": win["seconds"], "count": win["count"],
                       "model_flop": work["model_flop"]},
            "trace": dict(rec, model_samples=work.get(
                "trace_model_samples"))}


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, wrap=None,
             log=lambda *a: None) -> dict:
    bench = Bench(root)
    cell_entry = bench.cell(workload)
    run = SimpleNamespace(root=root, config=bench.config(
        cell_entry["config"]), traffic=bench.traffic(cell_entry["traffic"]),
        seed=int(seed), device=torch.device(device))
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    cell = bench.kind(run.traffic["kind"])(run, wrap)
    cell.sync()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    cpu0 = time.process_time()
    win = cell.window(seconds)
    log(f"window {win['seconds']:.3f} s, {win['count']} {cell.kind} calls; "
        f"host CPU {time.process_time() - cpu0:.3f} s")
    mem = torch.cuda.max_memory_allocated(run.device) \
        if run.device.type == "cuda" else 0
    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        t = time.perf_counter()
        rec = cell.traced(run.traffic["profile_count"])
        log(f"traced {time.perf_counter() - t:.3f} s; s a call: device "
            f"pass {rec['call_s']['device_pass']:.6f}, host pass "
            f"{rec['call_s']['host_pass']:.6f}, untraced window "
            f"{win['seconds'] / win['count']:.6f}")
        t = time.perf_counter()
        work = cell.work()
        log(f"model work {time.perf_counter() - t:.3f} s")
        record = per_layer_record(cell, win, rec, work)
        for m in bench.per_layer(workload):
            v = bench.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": rec["device_ops"],
                     "idle_gaps": rec["idle_gaps"]}
        dev_extra = {"busy_s": rec["busy_s"], "window_s": rec["window_s"]}
    else:
        e2e = cell.end_to_end(win, setup_s)
        for m in bench.end_to_end(workload):
            if m["name"] in e2e:
                v, unit = e2e[m["name"]]
                metrics[m["name"]] = {"value": v, "unit": unit}
    outputs = cell.outputs()
    cell.release()
    t = time.perf_counter()
    numbers = cell.numbers(outputs)
    log(f"reference {time.perf_counter() - t:.3f} s")
    ok, rows = check.judge(numbers, check.load_limits(bench.dir, workload))
    result = {"correct": bool(ok and win["failed"] == 0),
              "attempted": win["count"], "failed": win["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if run.device.type == "cuda"
                         else run.device.type,
                         "kind": torch.cuda.get_device_name(run.device)
                         if run.device.type == "cuda" else "cpu",
                         "count": 1, "memory_peak_bytes": int(mem),
                         **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = rows
    return result
