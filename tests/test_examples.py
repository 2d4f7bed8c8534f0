"""Execute every example script end-to-end (slow tier).

The reference's example notebooks carry real execution outputs
(``/root/reference/examples/model_api_example.ipynb``); this is the
equivalent regression guard for this repo's runnable examples: each
``examples/*.py`` runs in a subprocess on CPU with
``RRMPG_EXAMPLE_FAST=1`` (tiny sizes, few optimizer generations), so
deleting or breaking any public symbol an example uses turns CI red.

Subprocesses (rather than in-process exec) keep each example's JAX
state, global RNG and matplotlib state isolated, and match the
documented launch (exec from the repo root).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = sorted((REPO_ROOT / "examples").glob("[0-9]*.py"))

pytestmark = pytest.mark.slow


def _example_env():
    env = dict(os.environ)
    env["RRMPG_EXAMPLE_FAST"] = "1"
    # CPU execution even where an accelerator is present.
    env["JAX_PLATFORMS"] = "cpu"
    env.setdefault("XLA_FLAGS", "")
    if "--xla_force_host_platform_device_count" not in env["XLA_FLAGS"]:
        env["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
    # Share the suite's persistent compile cache (keyed by host CPU
    # flags in conftest; examples just need *a* stable dir).
    from conftest import _cache_dir
    env.setdefault("JAX_COMPILATION_CACHE_DIR", _cache_dir)
    env.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2.0")
    # Examples must not try to open display windows.
    env.setdefault("MPLBACKEND", "Agg")
    return env


def test_examples_discovered():
    assert len(EXAMPLES) == 10, [p.name for p in EXAMPLES]


def test_notebook_pipeline_executes(tmp_path):
    pytest.importorskip("nbclient")
    pytest.importorskip("ipykernel")
    """make_notebooks.py --execute runs a real kernel over a tutorial.

    The committed docs/notebooks/*.ipynb carry captured outputs; this
    executes the self-contained forecast-mode tutorial (its hidden
    nb-setup cells define the fragments' inputs) into a temp dir with
    nbclient and checks every code cell ran without error.
    """
    import nbformat

    proc = subprocess.run(
        [sys.executable, str(REPO_ROOT / "docs" / "make_notebooks.py"),
         "--execute", "06_forecast_mode", "--out-dir", str(tmp_path)],
        cwd=REPO_ROOT, env=_example_env(), capture_output=True,
        text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    nb = nbformat.read(tmp_path / "06_forecast_mode.ipynb", as_version=4)
    code_cells = [c for c in nb.cells if c.cell_type == "code"]
    assert len(code_cells) >= 4  # 2 visible + hidden setup cells
    for cell in code_cells:
        errs = [o for o in cell.outputs if o.output_type == "error"]
        assert not errs, errs
        assert cell.execution_count is not None  # actually executed
    # The convergence check's print survived into the executed notebook.
    streams = "".join(o.get("text", "") for c in code_cells
                      for o in c.outputs)
    assert "warm-fit loss" in streams


def test_docs_site_builds(tmp_path):
    """``make -C docs html`` equivalent: the static-site builder renders
    every page and the autodoc reference without error (the counterpart
    of the reference's Sphinx build)."""
    pytest.importorskip("markdown")
    proc = subprocess.run(
        [sys.executable, str(REPO_ROOT / "docs" / "build_site.py")],
        cwd=REPO_ROOT, env=_example_env(), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    site = REPO_ROOT / "docs" / "_site"
    pages = {p.name for p in site.glob("*.html")}
    assert {"index.html", "api.html", "performance.html",
            "reference.html"} <= pages
    ref = (site / "reference.html").read_text()
    # Autodoc really walked the package (symbols, not just headers).
    for sym in ("gr4j_ensemble_mse_pallas", "CAMELSLoader",
                "differential_evolution", "regional_snow_objective"):
        assert sym in ref, sym


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.stem)
def test_example_executes(path):
    # The documented launch: exec from the repo root (running
    # ``python examples/foo.py`` would put examples/ itself on sys.path).
    code = (f"exec(open({str(path)!r}).read(), "
            f"{{'__file__': {str(path)!r}, '__name__': '__main__'}})")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=_example_env(),
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, (
        f"{path.name} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-4000:]}\n"
        f"--- stderr ---\n{proc.stderr[-4000:]}")
    assert proc.stdout.strip(), f"{path.name} printed nothing"
