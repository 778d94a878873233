"""The port is whole: every part of the JAX tree has its counterpart in the
PyTorch port, or is named here with the reason it needs none. Reads files
only. A new module, script, entry point or Pallas kernel on the JAX side
fails a case until it is ported or listed.
"""

import pathlib
import re

REPO = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "adaface_tpu", REPO / "adaface_tpu_torch"

# JAX modules with no port file, and why
MODULES_WITHOUT_PORT = {
    "utils/compile_cache.py": "caches XLA compiles; eager PyTorch compiles nothing",
}
# scripts with no `_torch` twin, and why
SCRIPTS_WITHOUT_TWIN = {
    "soak_report.py": "numpy and the stdlib only; reads the metrics.csv the port's "
                      "utils/monitor.py writes",
    "sync_every_n_min.sh": "rsync of a log folder; runs no model",
    "export_jax_ckpt.py": "the port's own: exports the JAX trainer's checkpoints for it",
}
# root Python files that are no entry point of the JAX package, and why
ROOT_WITHOUT_TWIN = {
    "__graft_entry__.py": "a single-chip XLA compile check and a virtual-CPU mesh dry run of "
                          "the JAX UNet; the port's dp x tp dry run is tests/test_torch_tp.py",
    "conftest.py": "pytest's settings",
    "chip_smoke.py": "the port's own smoke run on the card",
    "chip_compare.py": "the port's own comparisons on the card",
}
# `pl.pallas_call` sites by JAX file, and the hand-written kernels that
# replace them in `adaface_tpu_torch/csrc/`
PALLAS_SITES = {
    "ops/attention.py": (2, ("flash_attn_wgmma.cu", "flash_attn_wide.cu", "flash_attn_fwd.cu")),
    "ops/fused_gn.py": (2, ("group_norm_silu.cu",)),
    "ops/fused_ln.py": (1, ("layer_norm.cu",)),
    "ops/fused_norm.py": (2, ("batch_norm_act.cu",)),
}


def test_every_module_has_a_port_file():
    jax_modules = {p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py")}
    assert set(MODULES_WITHOUT_PORT) <= jax_modules
    missing = {m for m in jax_modules if not (PORT_PKG / m).is_file()}
    assert missing == set(MODULES_WITHOUT_PORT)


def test_every_script_has_a_twin():
    scripts = REPO / "scripts"
    jax_side = {p.name for p in scripts.iterdir()
                if p.suffix in (".py", ".sh") and not p.stem.endswith("_torch")
                and not p.name.startswith("_")}
    assert set(SCRIPTS_WITHOUT_TWIN) <= jax_side
    missing = {n for n in jax_side
               if not (scripts / f"{pathlib.Path(n).stem}_torch{pathlib.Path(n).suffix}").is_file()}
    assert missing == set(SCRIPTS_WITHOUT_TWIN)
    # the shared helpers of the scripts
    assert (scripts / "_common.py").is_file() and (scripts / "_common_torch.py").is_file()


def test_every_entry_point_has_a_twin():
    roots = {p.name for p in REPO.glob("*.py") if not p.stem.endswith("_torch")}
    assert {"bench.py", "train.py", "app.py"} <= roots
    assert set(ROOT_WITHOUT_TWIN) <= roots
    missing = {n for n in roots if not (REPO / f"{n[:-3]}_torch.py").is_file()}
    assert missing == set(ROOT_WITHOUT_TWIN)


def test_every_pallas_kernel_has_a_hopper_kernel():
    sites = {}
    for p in JAX_PKG.rglob("*.py"):
        n = len(re.findall(r"\bpl\.pallas_call\(", p.read_text()))
        if n:
            sites[p.relative_to(JAX_PKG).as_posix()] = n
    assert sites == {f: n for f, (n, _) in PALLAS_SITES.items()}
    for f, (_, sources) in PALLAS_SITES.items():
        assert (PORT_PKG / f).is_file(), f
        for src in sources:
            assert (PORT_PKG / "csrc" / src).is_file(), src
