"""Where Mixtral's tp = 2 logits part from tp = 1's on one card (the port, PyTorch/CUDA).

Draws chip_smoke.py's Mixtral-8x7B at full width and `--layers` deep (the moe phase's
Q40 draw, seed 21), decodes chip_smoke's 100-token prompt and 16 greedy tokens on one
card at tp = 1 (bf16, the decode steps as CUDA graphs: the ep phase's reference), then
feeds those tokens to:

- tp = 1 eager in bf16 and in f32, every router call's top-k and sorted probabilities
  kept (the witness of the spread one card's own rounding makes);
- tp = 2 over gloo (two ranks time-slicing the card) under each layout the tree has
  ("slice", and "expert" where it exists): a fresh Engine, the same Engine again after
  reset(), and a fresh Engine whose routers are forced to tp = 1 bf16's top-k (the
  weights its own probabilities at those experts).

Per run: each step's max|Δlogits| / max|logits| against the reference, and the router
flips against tp = 1 bf16 eager (a token and layer whose chosen set differs), each with
tp = 1's gap between its k-th and (k+1)-th probability there. `--root` names the
checkout whose package runs; the draws, the sampler and the router log are this
checkout's chip_smoke.py, so a parent tree is measured by the same code. Writes <out>/ep_spread_<tag>.json and .npz; `--compare A.npz B.npz` reports
whether two trees' reference logits are bit-identical.

    python3 perf/ep_spread.py --root . --tag pr --out chiprun_out
"""
import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

SEED, TOKENS = 21, 16
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """This checkout's chip_smoke.py (its draws, sampler and router log), whatever
    checkout `--root` puts first on the path for the package."""
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
        sys.modules["chip_smoke"] = mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


def steps(rows, ref) -> list:
    scale = float(np.abs(ref[0]).max())
    return [float(np.abs(a - b).max()) / scale for a, b in zip(rows, ref)]


def rank(mesh, layers: int, fed: list, force: list, layouts: list) -> dict:
    from distributed_llama_tpu_torch.runtime.engine import Engine

    cs = smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = cs._mixtral_8x7b(layers)
    prompt = cs._prompt_100(spec)
    params = cs._random_moe_params(spec, mesh.device, seed=SEED)
    out = {}
    for layout in layouts:
        kw = {} if layout == "slice" else {"moe_sharding": layout}
        eng = Engine(spec, params, mesh=mesh, prefill_kernel=True, **kw)
        out[layout] = cs._fed_run(eng, spec, prompt, fed)
        out[layout + " reset"] = cs._fed_run(eng, spec, prompt, fed)
        del eng
        eng = Engine(spec, params, mesh=mesh, prefill_kernel=True, **kw)
        out[layout + " forced"] = cs._fed_run(eng, spec, prompt, fed, force)
        del eng
        torch.cuda.empty_cache()
    return out if mesh.rank == 0 else {}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--tag", default="pr")
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (np.load(p) for p in args.compare)
        same = all(np.array_equal(a[k], b[k]) for k in ("tokens", "rows"))
        print(json.dumps({"identical": same,
                          "max_abs": float(np.abs(a["rows"] - b["rows"]).max())}))
        return 0
    if not torch.cuda.is_available():
        print("ep_spread: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))
    cs = smoke()
    from distributed_llama_tpu_torch.parallel import launch, sharding
    from distributed_llama_tpu_torch.runtime.engine import Engine, GenerationStats

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cs.phase_build({})
    dev = torch.device("cuda")
    spec = cs._mixtral_8x7b(args.layers)
    k = spec.n_active_experts
    prompt = cs._prompt_100(spec)
    params = cs._random_moe_params(spec, dev, seed=SEED)
    eng = Engine(spec, params, prefill_kernel=True)
    first = eng.prefill(prompt)
    smp = cs._CheckedSampler(spec.vocab_size, keep=True)
    fed = eng._decode(first, TOKENS, smp, GenerationStats())
    ref = smp.kept
    del eng
    runs = {}
    for name, dtype in (("tp1 bf16 eager", None), ("tp1 f32 eager", torch.float32)):
        eng = Engine(spec, params, prefill_kernel=True, cuda_graph=False, dtype=dtype)
        runs[name] = cs._fed_run(eng, spec, prompt, fed)
        del eng
    del params
    torch.cuda.empty_cache()
    layouts = ["slice"] + (["expert"] if "expert" in getattr(
        sharding, "MOE_SHARDINGS", ()) else [])
    force = [c[0] for c in runs["tp1 bf16 eager"][1]]
    world = launch.run("ep_spread:rank", 2, "cuda:0", backend="gloo", deadline=1200,
                       args=(args.layers, fed, force, layouts))
    runs.update(world[0])
    base = runs["tp1 bf16 eager"][1]
    report = {"tag": args.tag, "layers": args.layers, "tokens": fed,
              "device": torch.cuda.get_device_name(0), "runs": {}}
    for name, (rows, calls) in runs.items():
        fl = cs._router_flips([c[0] for c in calls], base, k)
        report["runs"][name] = {
            "steps_vs_tp1_graphs": steps(rows, ref),
            "steps_vs_tp1_eager": steps(rows, runs["tp1 bf16 eager"][0]),
            "router_flips": len(fl), "flip_steps": sorted({c for c, _, _ in fl}),
            "max_gap_at_flip": max((g for _, _, g in fl), default=None),
            "flips": fl[:40]}
    for a in ("slice", "expert"):
        if a in runs:
            report["runs"][a]["reset_identical"] = all(
                np.array_equal(x, y) for x, y in zip(runs[a][0], runs[a + " reset"][0]))
    gaps = np.concatenate([p[0, :, k - 1] - p[0, :, k] for _, p in base])
    report["tp1_gap_quantiles"] = {q: float(np.quantile(gaps, q))
                                   for q in (0.001, 0.01, 0.1, 0.5)}
    report["seconds"] = round(time.perf_counter() - t0, 1)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"ep_spread_{args.tag}.json"), "w") as f:
        json.dump(report, f, indent=1)
    np.savez(os.path.join(args.out, f"ep_spread_{args.tag}.npz"), tokens=np.array(fed),
             rows=np.stack(ref))
    for name, r in report["runs"].items():
        print(f"{args.tag} | {name}: worst step vs tp1 graphs "
              f"{max(r['steps_vs_tp1_graphs']):.3e} (step 0 {r['steps_vs_tp1_graphs'][0]:.3e},"
              f" 1 {r['steps_vs_tp1_graphs'][1]:.3e}); vs tp1 eager "
              f"{max(r['steps_vs_tp1_eager']):.3e}; router flips {r['router_flips']} at calls "
              f"{r['flip_steps'][:12]}, max tp1 gap there {r['max_gap_at_flip']}"
              + (f"; reset identical {r['reset_identical']}" if "reset_identical" in r else ""))
    print(f"{args.tag} | tp1 router gap quantiles {report['tp1_gap_quantiles']}; "
          f"{report['seconds']} s; {report['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
