"""One cell of the dry run with overrides, and its roofline terms
(counterpart of ``repro.launch.perf``).

Records one (arch x shape) cell on meta tensors (``launch/dryrun.py``),
with config, step and optimizer overrides, and prints the three roofline
terms, so each hypothesis -> change -> measure cycle of the plan is one
invocation. Like the JAX tool, it runs nothing on a device:

    PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen3-4b --shape train_4k \\
        --tag H1_chunked --set attn_impl=chunked attn_chunk_q=1024 \\
        --microbatches 4 --optimizer rmnp [--remat dots] [--grad-dtype bfloat16]

The record and its ``roofline_row`` land in
``artifacts/perf/<arch>__<shape>__<tag>.json``. ``--profile`` prints the
ops by bytes (``launch/cost.StepCounter.breakdown``). ``--rules`` (the JAX
package's logical-axis sharding rules) has no counterpart: the port has no
logical axes and no ``model`` axis to map them to (ROADMAP Queue 1, the
logical-axis sharding over ``model``), so the flag raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, mesh as mesh_lib
from repro_torch.launch.roofline import roofline_row

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "perf"
NO_RULES = ("--rules: the port has no logical-axis sharding (no 'model' axis); "
            "see ROADMAP.md Queue 1, the logical-axis sharding over the model axis")


def _parse_overrides(pairs):
    """``["k=v", ...]`` -> ``{k: v}``, each value an int, else a float, else
    the string (``src/repro/launch/perf.py:39``)."""
    out = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        out[k] = v
    return out


def apply_overrides(cfg, overrides):
    """``cfg`` with ``overrides`` (``moe_dispatch`` goes into ``cfg.moe``)."""
    if not overrides:
        return cfg
    overrides = dict(overrides)
    md = overrides.pop("moe_dispatch", None)
    if md is not None and cfg.moe is not None:
        overrides["moe"] = dataclasses.replace(cfg.moe, dispatch=md)
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def run(arch: str, shape_name: str, tag: str, *, cfg_overrides=None,
        optimizer: str = "rmnp", microbatches: int = 4, remat: str = "full",
        grad_dtype=None, rules=None, multi_pod: bool = False, profile: bool = False,
        out_dir: Path = ARTIFACTS) -> dict:
    """Record the cell, write the record with its roofline row and print
    the ``[perf]`` line."""
    if rules:
        raise NotImplementedError(NO_RULES)
    cfg = apply_overrides(get_config(arch), cfg_overrides)
    shape = SHAPES[shape_name]
    world = mesh_lib.make_production_world(multi_pod=multi_pod)
    why = dryrun.skip_reason(cfg, shape, world.size, microbatches)
    if why:
        raise ValueError(f"{arch} x {shape_name}: {why}")
    cell = f"{arch}__{shape_name}__{tag}"
    rec = dryrun.record(cfg, shape, world.size, cell=cell, jax_world=world,
                        optimizer=optimizer, microbatches=microbatches, remat=remat,
                        grad_dtype=grad_dtype, keep_counter=profile)
    counter = rec.pop("counter", None)
    rec.update(tag=tag, overrides={k: str(v) for k, v in (cfg_overrides or {}).items()})
    row = roofline_row(rec)
    rec["roofline"] = row
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell}.json").write_text(json.dumps(rec, indent=1))
    if counter is not None:
        agg, top = counter.breakdown()
        print("-- per-op HBM traffic (GiB) --")
        for k, v in list(agg.items())[:10]:
            print(f"  {k:40s} {v['bytes'] / 2**30:10.1f}")
        print("-- top traffic ops --")
        for b, _name, shapes in top:
            print(f"  {b / 2**30:9.1f} GiB  {shapes[:150]}")
        print("-- collectives (wire GiB) --")
        for k, v in sorted(rec["collectives"].items(), key=lambda kv: -kv[1]["wire_bytes"]):
            if v["count"]:
                print(f"  {k:20s} n={v['count']:<8d} {v['wire_bytes'] / 2**30:10.1f}")
    print(f"[perf] {cell}: t_comp={row['t_compute_s']:.3f}s "
          f"t_mem={row['t_memory_s']:.3f}s t_coll={row['t_collective_s']:.3f}s "
          f"dominant={row['dominant']} roofline={row['roofline_fraction']:.4f} "
          f"mem={rec['memory']['bytes_per_device'] / 2**30:.2f}GiB "
          f"fits={row['fits']} (record {rec['record_s']:.0f}s)", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="one dry-run cell with overrides")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", nargs="*", default=None, help="ModelConfig overrides k=v")
    ap.add_argument("--rules", nargs="*", default=None,
                    help="has no counterpart in the port: raises")
    ap.add_argument("--optimizer", default="rmnp")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--grad-dtype", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)
    run(args.arch, args.shape, args.tag, cfg_overrides=_parse_overrides(args.set) or None,
        optimizer=args.optimizer, microbatches=args.microbatches, remat=args.remat,
        grad_dtype=args.grad_dtype, rules=args.rules, multi_pod=args.multi_pod,
        profile=args.profile)


if __name__ == "__main__":
    main()
