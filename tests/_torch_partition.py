"""Shared helpers of the partitioned dry-run tests: the reference's
per-chip counts of compiled cells, in a subprocess with 256 or 512 forced
host devices on a mesh of Auto axes, and the port's partitioned counts of
the same cells (`dryrun.run_partitioned` over a "fake" process group).

The reference's own `make_production_mesh` calls `jax.make_mesh` without
axis types, which the installed jax 0.9 makes Explicit: on that mesh the
train cells do not lower and the others compile with the whole cell on
every chip. jax < 0.5, which the pyproject names, made Auto axes, so the
subprocess builds the mesh with Auto axes itself."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]

REF_CODE = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import AxisType
    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import build_cell
    n = int(sys.argv[1])
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if n == 512
                    else ((16, 16), ("data", "model")))
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    out = {}
    for cell in sys.argv[2:]:
        arch, sh = cell.split("/")
        with jax.set_mesh(mesh):
            plan = build_cell(arch, sh, mesh)
            compiled = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                               out_shardings=plan.out_shardings,
                               donate_argnums=plan.donate_argnums).lower(*plan.args).compile()
        t = analyze(compiled.as_text())
        out[cell] = {"flops": t.flops, "coll_bytes": t.coll_bytes,
                     "coll_counts": t.coll_counts}
    print(json.dumps(out))
""")


WHARF_REF_CODE = textwrap.dedent("""
    import dataclasses, json, sys, time
    import jax
    from jax.sharding import AxisType
    from repro.configs import get_arch
    from repro.launch.hlo_analysis import analyze
    from repro.launch.steps import _wharf_plan
    n, log2_n, cap, max_pending, n_batches = map(int, sys.argv[1:6])
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if n == 512
                    else ((16, 16), ("data", "model")))
    mesh = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    spec = get_arch("wharf-stream")
    cfg = dataclasses.replace(spec.make_config(False), n_vertices=1 << log2_n,
                              edge_capacity=(1 << log2_n) * 128, rewalk_capacity=cap,
                              max_pending=max_pending)
    out = {}
    for cell in sys.argv[6:]:
        info = dict(spec.shapes[cell])
        if n_batches and "n_batches" in info:
            info["n_batches"] = n_batches
        t0 = time.time()
        try:
            # no jax.set_mesh: under it the sharded cell's shard_map over the
            # flat ("shard",) mesh does not lower
            plan = _wharf_plan("wharf-stream", cfg, info, mesh, cell)
            compiled = jax.jit(plan.fn, in_shardings=plan.in_shardings,
                               out_shardings=plan.out_shardings,
                               donate_argnums=plan.donate_argnums).lower(*plan.args).compile()
            t = analyze(compiled.as_text())
            out[cell] = {"flops": t.flops, "bytes": t.mem_bytes, "coll_bytes": t.coll_bytes,
                         "coll_counts": t.coll_counts, "compile_s": time.time() - t0}
        except Exception as e:  # a cell that does not lower is recorded, the rest run
            out[cell] = {"error": repr(e)[:400]}
    print(json.dumps(out))
""")


def start_wharf_reference(n_devices: int, cells, log2_n: int, rewalk_capacity: int,
                          max_pending: int, n_batches: int) -> subprocess.Popen:
    """The reference's per-chip counts of wharf `cells` (shape names) at the
    full config cut to 2^log2_n vertices as `dryrun.wharf_config` cuts it,
    compiled for `n_devices` forced host devices, outside `jax.set_mesh`."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT / "src"),
                                                      os.environ.get("PYTHONPATH")) if p))
    args = [str(v) for v in (n_devices, log2_n, rewalk_capacity, max_pending, n_batches)]
    return subprocess.Popen([sys.executable, "-c", WHARF_REF_CODE, *args, *cells], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def start_reference(n_devices: int, cells) -> subprocess.Popen:
    """The reference's per-chip counts of `cells` ("arch/shape"), compiled
    for `n_devices` (256: 16 x 16, 512: 2 x 16 x 16) forced host devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}",
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT / "src"),
                                                      os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen([sys.executable, "-c", REF_CODE, str(n_devices), *cells],
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_reference(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def port_counts(multi_pod: bool, cells) -> dict:
    """The port's partitioned records of `cells` on the production mesh."""
    from repro_torch.launch import dryrun
    with dryrun.fake_mesh(multi_pod) as mesh:
        return {c: dryrun.run_partitioned(*c.split("/"), mesh, verbose=False) for c in cells}


def one_card_counts(cells) -> dict:
    """The one-card records (`mesh` "1") of `cells`."""
    from repro_torch.launch import dryrun
    return {c: dryrun.run_cell(*c.split("/"), verbose=False) for c in cells}


if __name__ == "__main__":
    # the reference's per-chip counts of wharf cells at a cut, e.g.
    #   python tests/_torch_partition.py 256 14 8192 2 1 stream_10k stream_10k_sharded
    n_dev, log2_n, cap, pend, nb = map(int, sys.argv[1:6])
    print(json.dumps(finish_reference(start_wharf_reference(
        n_dev, sys.argv[6:], log2_n, cap, pend, nb)), indent=1))
