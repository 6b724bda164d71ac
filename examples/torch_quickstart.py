"""Quickstart on the PyTorch port: train a small LM with the full stack
(data pipeline -> train step under the memory plan's checkpoint policy ->
checkpoint -> restore), then compile a layer-basis graph down to its
lowered ExecutionSchedule, prove it memory-safe with the static verifier
(``repro_torch.core.verify``, on by default), watch the verifier catch a
dropped Prefetch, and replay the plan on the async backend (the CUDA copy
stream on the card), printing its overlap report.  Then compile vgg16
with planner-managed optimizer-state offload and print the plan summary,
serve users through the multi-tenant personalization service (shared
plans per batch bucket, admission-controlled arena shares, pad-to-bucket
batching), and drain the same service phase-interleaved with two QoS
classes (over an emulated bus on the CPU).

The port of ``examples/quickstart.py``.  It runs on the CUDA card; pass
``--device cpu`` for the plain PyTorch path on the host:

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""

import argparse
import tempfile

import torch

from repro_torch.configs import ARCHS
from repro_torch.core import MemoryPlanConfig, compile_plan
from repro_torch.core.zoo import ZOO
from repro_torch.device import resolve_device
from repro_torch.models.model import reduce_config
from repro_torch.train.trainer import quick_train

# the swap-forcing plan of the graph demos (lenet5 swaps nothing under
# the default config)
SWAPPING = dict(min_idle_phases=3, min_bytes=1 << 12)


def train_demo(device, steps: int = 30, resume_steps: int = 40) -> dict:
    """A reduced llama3.2-3b trained ``steps`` steps with checkpoints, then
    resumed from the last one to ``resume_steps``."""
    # remat=True so the compiled memory plan has real keep/offload content
    cfg = reduce_config(ARCHS["llama3.2-3b"], n_layers=2, d_model=64,
                        vocab=512, remat=True)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        print(f"== training reduced {cfg.name} "
              f"({cfg.n_layers}L d={cfg.d_model}) on {device} ==")
        out = quick_train(cfg, steps=steps, seq_len=64, global_batch=8,
                          ckpt_dir=ckpt_dir, device=device)
        # the train step compiled its memory plan through compile_plan;
        # the report travels with the run result
        mp = out["memory_plan"]
        print(f"memory plan: peak={mp['peak_bytes'] / 2**20:.2f} MiB "
              f"decisions={mp.get('remat_decisions', {})} "
              f"dma={mp.get('dma_bytes', 0) / 2**20:.2f} MiB "
              f"recompute_flops/layer="
              f"{mp.get('recompute_flops_per_layer', 0.0):.3g}")
        first = out["history"][0]["loss"]
        print(f"loss: {first:.3f} -> {out['final_loss']:.3f}")
        assert out["final_loss"] < first, "training did not reduce loss"

        print("== resuming from checkpoint ==")
        out2 = quick_train(cfg, steps=resume_steps, seq_len=64,
                           global_batch=8, ckpt_dir=ckpt_dir, device=device)
        print(f"resumed loss: {out2['final_loss']:.3f}")
    return {"first": first, "final": out["final_loss"],
            "resumed": out2["final_loss"]}


def graph_plan_demo() -> dict:
    """The layer-basis path: one compile step from graph to executor ops,
    with the pinned-host pool packed by its own allocator."""
    cp = compile_plan(
        ZOO["lenet5"](),
        MemoryPlanConfig(planner="bestfit", host_planner="segregated",
                         **SWAPPING),
        batch=16)
    r = cp.report()
    print(f"== lenet5 graph plan (planner={r['planner']}, "
          f"host_planner={r['host_planner']}) ==")
    print(f"peak={r['peak_bytes'] / 2**20:.2f} MiB "
          f"(baseline {r['baseline_peak_bytes'] / 2**20:.2f}) "
          f"host={r['host_pool_bytes'] / 2**20:.2f} MiB "
          f"dma={r['dma_bytes'] / 2**20:.2f} MiB")
    print(f"device_utilization={r['device_utilization']:.3f} "
          f"host_utilization={r['host_utilization']:.3f} "
          f"inplace_prefetches={r['inplace_prefetch_count']}")
    print(f"lowered schedule ops: {r['schedule_ops']}")
    for op in cp.lowered.transfers()[:4]:
        print(f"  {type(op).__name__:8s} eo={op.eo:3d} {op.tensor} "
              f"dev@{op.device_offset} host@{op.host_offset}")
    # every compile runs the static verifier (verify="error", the
    # default): the schedule was proven memory-safe before any op ran
    v = r["verify"]
    print(f"verified: ok={v['ok']} checks={','.join(v['checks_run'])} "
          f"ops_scanned={v['ops_scanned']} "
          f"wall={v['wall_time_s'] * 1e3:.1f} ms")
    # the dependence analyser rides the same compile: happens-before edge
    # counts, the fusion plan jit_blocks dispatches, prefetch slack
    d = r["deps"]
    f = d["fusion"]
    print(f"deps: edges={d['edges']} "
          f"prefetch_slack_min={d['min_prefetch_slack_phases']} phases")
    print(f"fusion plan: {f['n_blocks']} blocks covering "
          f"{f['fused_computes']}/{f['n_computes']} computes "
          f"(largest {f['largest_block']}), dispatch_calls="
          f"{f['dispatch_calls']} vs {f['n_ops']} ops, "
          f"splits={f['splits']}")
    return r


def verify_demo() -> dict:
    """The static verifier catching a forged corruption: drop one Prefetch
    from a lowered schedule and the use-before-resident checker names the
    tensor and phases in a structured Diagnostic."""
    from repro_torch.core.plan import ExecutionSchedule, Prefetch
    from repro_torch.core.verify import verify_schedule

    cp = compile_plan(
        ZOO["lenet5"](),
        MemoryPlanConfig(planner="bestfit", host_planner="segregated",
                         **SWAPPING),
        batch=16)
    dropped = next(op for op in cp.lowered.ops if isinstance(op, Prefetch))
    forged = ExecutionSchedule(
        ops=tuple(op for op in cp.lowered.ops if op is not dropped))
    report = verify_schedule(cp.ordered, cp.schedule, cp.plan, forged)
    print("== verifier vs a forged schedule (one Prefetch dropped) ==")
    for d in report.errors()[:3]:
        print(f"  {d.render()}")
    assert not report.ok and "use_before_resident" in report.check_ids()
    return report.summary()


def async_exec_demo(device) -> dict:
    """The async backend: the same compiled plan, every SwapOut/Prefetch a
    non-blocking copy on the CUDA copy stream (an emulated bus on the
    CPU), dispatched ahead of need and fenced at the consumer."""
    g = ZOO["lenet5"]()
    cp = compile_plan(g, MemoryPlanConfig(executor="async", **SWAPPING),
                      batch=16)
    params = cp.init_params(torch.Generator(device).manual_seed(0),
                            device=device)
    gen = torch.Generator(device).manual_seed(1)
    x = torch.randn((16,) + tuple(g.input_shape), generator=gen,
                    device=device)
    y = torch.nn.functional.one_hot(torch.arange(16, device=device) % 10,
                                    10).float()
    loss, _, stats = cp.loss_and_grads(params, x, y)
    ex = cp.report()["exec"]      # the backend's post-run overlap report
    print(f"== lenet5 async executor on {device} "
          f"(loss={float(loss):.3f}) ==")
    print(f"backend={ex['backend']} "
          f"transfers={ex['swap_outs']}+{ex['prefetches']} "
          f"dma={ex['dma_bytes'] / 2**20:.2f} MiB")
    overlap = ex["achieved_overlap"]
    print(f"achieved_overlap="
          f"{'n/a' if overlap is None else format(overlap, '.2f')} "
          f"stalled_fences={ex['stalled_fences']} "
          f"inflight_high_water={ex['inflight_high_water'] / 2**20:.2f} MiB "
          f"(planned {ex['planned_peak_inflight_prefetch'] / 2**20:.2f} MiB)")
    assert stats.replayed_ops == cp.lowered.ops
    return ex


def optim_offload_demo() -> dict:
    """Planner-managed optimizer-state offload: the AdamW moments are
    ``O:<layer>`` slots in the EO graph, priced by the joint cost model,
    packed into their own device and host arenas and lowered to typed
    OptPrefetch/OptSwapOut ops; the host copy is int8 block-scaled with
    error feedback."""
    from repro_torch.core.plan import OptPrefetch, OptSwapOut

    mib = 2 ** 20
    cp = compile_plan(ZOO["vgg16"](),
                      MemoryPlanConfig(optim_offload=True, **SWAPPING),
                      batch=4)
    s = cp.optim_plan.summary()
    print("== vgg16 optimizer-state offload (AdamW moments) ==")
    print(f"slots={s['n_slots']} "
          f"resident={s['resident_bytes'] / mib:.1f} MiB -> "
          f"device working region {s['device_peak_bytes'] / mib:.1f} MiB "
          f"({s['reduction_x']:.2f}x reduction)")
    print(f"host copies: int8+scales {s['host_pool_bytes'] / mib:.1f} MiB "
          f"vs fp32 {s['host_fp32_bytes'] / mib:.1f} MiB, "
          f"dma/step={s['dma_bytes_per_step'] / mib:.1f} MiB "
          f"(est {s['est_dma_s_per_step'] * 1e3:.2f} ms)")
    n_pre = sum(isinstance(op, OptPrefetch) for op in cp.lowered.ops)
    n_out = sum(isinstance(op, OptSwapOut) for op in cp.lowered.ops)
    v = cp.report()["verify"]
    print(f"lowered: {n_pre} OptPrefetch + {n_out} OptSwapOut ops, "
          f"verified ok={v['ok']} "
          f"({len(v['checks_run'])} checks incl. optim_region)")
    assert cp.optim_plan.reduction_x >= 3.0
    assert v["ok"] and "optim_region" in v["checks_run"]
    return cp.report()


def serve_demo(device) -> dict:
    """Serve 4 users: multi-tenant personalization over one device arena,
    every user sharing the frozen base tree and one compiled plan per
    batch bucket; admission control splits the arena between sessions."""
    from repro_torch.serve import PersonalizationService
    from repro_torch.serve.buckets import dummy_batch

    g = ZOO["lenet5"]()
    svc = PersonalizationService(g, buckets=(8, 16), max_live_sessions=4,
                                 device=device)
    svc.warmup()
    print(f"== serving 4 users over 2 buckets (lenet5) on {device} ==")
    for u in range(4):
        n = 5 if u % 2 else 12        # short batches pad up to a bucket
        res = svc.submit(f"user{u}", *dummy_batch(g, n, seed=u,
                                                  device=device))
        print(f"  user{u}: {res.status} bucket={res.bucket} "
              f"loss={res.loss:.3f} peak={res.peak_bytes} "
              f"share={res.arena_share_bytes}")
        assert res.ok and res.peak_bytes <= res.arena_share_bytes
    rep = svc.report()
    cache, adm = rep["plan_cache"], rep["admission"]
    print(f"plan cache: {cache['entries']} plans for "
          f"{adm['live_sessions']} sessions "
          f"(hits={cache['hits']} misses={cache['misses']}), "
          f"arena share={adm['arena_share_bytes']} B/session, "
          f"deadlocks={rep['serve']['deadlocks']}")
    return rep


def concurrent_serve_demo(device) -> dict:
    """Phase-interleaved serving: two QoS classes share the device, their
    swaps on one copy stream (the card's own bus; on the CPU an emulated
    UFS-class bus, as the reference's demo paces it).  The scheduler
    round-robins every live session's cursor at phase boundaries, so one
    tenant's swaps stream while another tenant's compute runs."""
    from repro_torch.serve import PersonalizationService, QosClass
    from repro_torch.serve.buckets import dummy_batch

    g = ZOO["lenet5"]()
    qos = (QosClass("premium", 2.0, slots=1),
           QosClass("standard", 1.0, slots=3))
    bus = {} if device.type == "cuda" else dict(bus_gbps=0.2,
                                                bus_latency_s=0.004)
    svc = PersonalizationService(
        g, buckets=(8, 16), max_live_sessions=4, qos=qos, interleave=True,
        config=MemoryPlanConfig(**SWAPPING), device=device, **bus)
    svc.warmup()
    print("== concurrent serving: 4 users, premium + standard QoS ==")
    reqs = [svc.enqueue(f"user{u}", *dummy_batch(g, 12, seed=u,
                                                 device=device),
                        qos="premium" if u == 0 else "standard")
            for u in range(4)]
    svc.drain()                    # one interleaved stream, all sessions
    for u, req in enumerate(reqs):
        res = req.result
        print(f"  user{u} [{res.qos}]: {res.status} loss={res.loss:.3f} "
              f"share={res.arena_share_bytes} B "
              f"queue_wait={res.queue_wait_s * 1e3:.1f} ms")
        assert res.ok and res.peak_bytes <= res.arena_share_bytes
    rep = svc.report()
    sched = rep["scheduler"]
    hidden = sched["hidden_dma_s"] + sched["opt_hidden_dma_s"]
    exposed = sched["exposed_dma_s"] + sched["opt_exposed_dma_s"]
    print(f"hidden bus time: {hidden * 1e3:.1f} ms under compute "
          f"({sched['cross_hidden_dma_s'] * 1e3:.1f} ms under other "
          f"sessions'), exposed {exposed * 1e3:.1f} ms, "
          f"verify_errors={sched['verify_errors']}")
    for name, q in rep["serve"]["by_qos"].items():
        print(f"  qos {name}: completed={q['completed']} "
              f"bypassed_phases={q['bypassed_phases']}")
    assert sched["verify_errors"] == 0
    return rep


def main(device=None, train_steps: int = 30,
         resume_steps: int = 40) -> dict:
    """Every demo in turn on ``device`` (the CUDA card when None); returns
    each demo's report."""
    dev = resolve_device(device)
    return {"train": train_demo(dev, train_steps, resume_steps),
            "graph_plan": graph_plan_demo(),
            "verify": verify_demo(),
            "async": async_exec_demo(dev),
            "optim_offload": optim_offload_demo(),
            "serve": serve_demo(dev),
            "concurrent_serve": concurrent_serve_demo(dev)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
