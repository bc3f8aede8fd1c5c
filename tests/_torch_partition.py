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
