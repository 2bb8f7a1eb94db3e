"""Observability demo on the PyTorch / CUDA port: trace a serving run,
audit it, localize faults.

1. Serve ResNet-18 at 2 x BestRate under SLA shedding with tracing on
   (``ServeConfig(trace=True)``) and print the metrics snapshot next
   to the engine's pinned summary row.
2. Dump the span timeline to ``trace.json`` — Chrome trace-event JSON,
   viewable at https://ui.perfetto.dev (one lane per stage,
   queue-depth counter tracks, exact Fraction ticks in the args).
3. Run the drift auditor on the trace alone: it reproduces every
   engine verdict (occupancy vs Eq. 9/10 bound, queue bounds, stalls)
   and checks the calculus continuously per window.
4. Re-serve the table8 adversarial overload (arrivals just above
   BestRate): backpressure stalls the upstream stage and the auditor
   names the exact first stall tick.
5. Tamper with one span's service time in the dumped JSON and watch
   the auditor flag the exact window: the deterministic tick model
   means a stage span must last exactly frames x utilization ticks.

The engine runs its tick model (``execute=False``), so no frame reaches
the device; ``--device`` is resolved as every entry point of the port
resolves it.

Usage:  PYTHONPATH=src python examples/trace_demo_torch.py [--device cpu]
"""
import argparse
from fractions import Fraction as F

from repro_torch.core.graph import plan_graph
from repro_torch.models.registry import get_cnn_api, resolve_device
from repro_torch.obs import Tracer, audit
from repro_torch.serving import PlanLadder, ServeConfig, ShedPolicy, adversarial
from repro_torch.serving.cnn_stream import CNNStreamEngine, best_rate_frames

RATE = F(5, 2)
N_STAGES = 2
MICROBATCH = 4
N_FRAMES = 48


def _serve(graph, plan, arrival, *, overload=None, n=N_FRAMES):
    cfg = ServeConfig(microbatch=MICROBATCH, execute=False,
                      arrival=arrival, overload=overload, trace=True)
    eng = CNNStreamEngine(graph, None, plan, cfg)
    for _ in range(n):
        eng.submit(None)
    return eng.run()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    api = get_cnn_api("resnet18", device="cpu")      # the graph only
    graph = api.graph(api.make_config())
    plan = plan_graph(graph, RATE, n_stages=N_STAGES)
    br = best_rate_frames(plan)

    print(f"=== 1. serve at 2 x BestRate ({2 * br} f/tick) with shedding ===")
    rep = _serve(graph, plan, 2 * br,
                 overload=ShedPolicy(deadline_ticks=F(24)))
    summary = rep.summary()
    print(f"  engine row: {summary.line(over_best=True)}")
    snap = summary.metrics
    for key in sorted(snap):
        if key.startswith(("frames_", "shed_", "stage_busy")):
            print(f"  metric {key} = {snap[key]}")

    print("\n=== 2. dump the span timeline ===")
    rep.trace.write("trace.json")
    print(f"  wrote trace.json ({len(rep.trace.events)} events; drop it "
          "into https://ui.perfetto.dev)")

    print("\n=== 3. audit the trace against Eq. 9/10 ===")
    ar = audit(rep.trace)
    print(f"  {ar.verdict_line()}")
    print(f"  verdicts agree with the engine: {ar.matches(summary)}")

    print("\n=== 4. localize backpressure under adversarial overload ===")
    ladder = PlanLadder.build(graph, RATE, n_stages=N_STAGES,
                              rate_factors=(1, 2), try_replicate=True)
    lplan = ladder.rungs[0].plan
    rep_adv = _serve(graph, lplan, adversarial(best_rate_frames(lplan)),
                     n=768)
    ar_adv = audit(rep_adv.trace)
    print(f"  {ar_adv.verdict_line()}")
    print(f"  engine agrees: {ar_adv.matches(rep_adv.summary())}")

    print("\n=== 5. tamper with one span; the auditor finds the window ===")
    data = rep.trace.to_chrome()
    stage_e = [ev for ev in data["traceEvents"]
               if ev.get("name") == "stage" and ev.get("ph") == "E"]
    last = max(stage_e, key=lambda ev: F(ev["args"]["__t__"]))
    t = F(last["args"]["__t__"]) + 1
    last["args"]["__t__"] = f"{t.numerator}/{t.denominator}"
    last["ts"] += 1.0
    ar_bad = audit(Tracer.from_chrome(data))
    print(f"  clean: {ar_bad.clean}")
    print(f"  {ar_bad.localization()}")


if __name__ == "__main__":
    main()
