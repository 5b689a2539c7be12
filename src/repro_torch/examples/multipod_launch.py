"""Launch-surface example (PyTorch port of ``examples/multipod_launch.py``):
what a production multi-pod job submission looks like. Resolve an
(arch, shape) cell, build the mesh and the shardings, and dry-run it as
``launch/train.py`` or ``launch/serve.py`` would lay it out on real
hardware.

    PYTHONPATH=src python -m repro_torch.examples.multipod_launch \\
        --arch olmo-1b --shape train_4k --mesh multi

The dry-run is ``launch/dryrun.py::run_cell``: rank 0 of the mesh's 256
or 512 ranks, on torch's ``fake`` process group, runs its step once on
the meta device (no storage is allocated and nothing computes; it runs on
the host). The lines are the reference's, with the build and step times
where it printed its compile time, and the fit judged against an 80 GB
H100.
"""

from __future__ import annotations

import argparse

from repro_torch.launch.dryrun import per_device_gib, run_cell

H100_BYTES = 80e9


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="multi", choices=["single", "multi"])
    args = ap.parse_args(argv)

    rec = run_cell(args.arch, args.shape, args.mesh, save=False)
    if rec["status"] != "ok":
        raise SystemExit(f"dry-run failed: {rec['error']}")

    per_dev = per_device_gib(rec)
    coll = rec["collectives"]
    flops = rec["flops_total"]
    print(f"\n{args.arch} x {args.shape} on the "
          f"{'2x16x16 multi-pod' if args.mesh == 'multi' else '16x16'} "
          f"mesh ({rec['n_devices']} ranks):")
    print(f"  build time          {rec['build_s']:.1f}s")
    print(f"  step time (meta)    {rec['run_s']:.1f}s")
    print(f"  memory/device       {per_dev:.2f} GiB "
          f"(fits an 80 GB H100: {per_dev * 2 ** 30 < H100_BYTES})")
    print(f"  FLOPs/device        "
          f"{'n/a' if flops is None else f'{flops:.3e}'}")
    print("  collective schedule:")
    for kind, v in coll.items():
        if v["count"]:
            print(f"    {kind:20s} x{v['count']:<4d} "
                  f"{v['bytes'] / 2**20:10.1f} MiB")
    return rec


if __name__ == "__main__":
    main()
