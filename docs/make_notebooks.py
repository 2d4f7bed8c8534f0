"""Render the markdown tutorials as Jupyter notebooks.

The reference ships its tutorials as ``.ipynb`` rendered into Sphinx RST
(``/root/reference/docs/source/index.rst:1-27``); this repo's canonical
tutorial source is markdown with captured output
(``docs/tutorials/*.md``).  This script closes the format gap: each
tutorial becomes ``docs/notebooks/<name>.ipynb`` where ``python`` fences
are code cells and a ``text`` fence that immediately follows one is
attached to it as captured stream output (so the notebook shows real
device results without requiring a card to re-execute).

Run from the repo root:  ``python docs/make_notebooks.py``
The generated notebooks are committed; re-run after editing a tutorial.

Execution mode (``--execute [stems...]``): notebooks whose tutorials
carry ``<!-- nb-setup ... -->`` blocks are *self-contained* -- the
hidden blocks become collapsed setup cells defining the variables the
visible cells use -- and can be executed for real with nbclient,
replacing the pasted outputs with live ones.  ``--out-dir`` redirects
the written notebooks (CI executes into a temp dir so the committed
notebooks keep their captured outputs; see
``tests/test_examples.py``).
"""

import pathlib
import re

import nbformat
from nbformat.v4 import (
    new_code_cell,
    new_markdown_cell,
    new_notebook,
    new_output,
)

FENCE = re.compile(r"^```(\w*)\s*$")
SETUP_OPEN = re.compile(r"^<!--\s*nb-setup\s*$")
SETUP_CLOSE = re.compile(r"^-->\s*$")


def _parse_blocks(text):
    """Split markdown into ('md'|'code'|'out'|'setup', body) blocks.

    A ``<!-- nb-setup`` ... ``-->`` HTML comment (invisible in rendered
    markdown) becomes a 'setup' block: a real code cell, collapsed in
    the notebook, that makes the surrounding fragments executable.
    """
    blocks = []
    lines = text.splitlines()
    buf, mode = [], "md"
    for line in lines:
        if mode == "md" and SETUP_OPEN.match(line):
            if buf:
                blocks.append(("md", "\n".join(buf).strip()))
            buf, mode = [], "setup"
            continue
        if mode == "setup":
            if SETUP_CLOSE.match(line):
                blocks.append(("setup", "\n".join(buf).strip()))
                buf, mode = [], "md"
            else:
                buf.append(line)
            continue
        m = FENCE.match(line)
        if m and mode == "md":
            if buf:
                blocks.append(("md", "\n".join(buf).strip()))
            lang = m.group(1)
            buf, mode = [], ("code" if lang == "python" else
                            "out" if lang in ("text", "") else "fence-" +
                            lang)
        elif m and mode != "md":
            kind = mode if mode in ("code", "out") else "md"
            body = "\n".join(buf)
            if kind == "md":  # non-python fence: keep verbatim markdown
                body = f"```{mode[6:]}\n{body}\n```"
            blocks.append((kind, body))
            buf, mode = [], "md"
        else:
            buf.append(line)
    if buf and "\n".join(buf).strip():
        blocks.append(("md", "\n".join(buf).strip()))
    return [b for b in blocks if b[1].strip() or b[0] != "md"]


def convert(md_path, out_path, execute=False):
    blocks = _parse_blocks(md_path.read_text())
    cells = []
    executable = any(kind == "setup" for kind, _ in blocks)
    for kind, body in blocks:
        if kind == "setup":
            cell = new_code_cell(body)
            cell.metadata["tags"] = ["nb-setup"]
            cell.metadata["jupyter"] = {"source_hidden": True}
            cells.append(cell)
        elif kind == "code":
            cells.append(new_code_cell(body))
        elif kind == "out":
            # Captured output attaches to the most recent code cell
            # (tutorials put a "## Captured output" heading between the
            # final code block and its output fence).
            last_code = next((c for c in reversed(cells)
                              if c.cell_type == "code"), None)
            if last_code is not None:
                last_code.outputs = list(last_code.outputs) + [new_output(
                    "stream", name="stdout", text=body + "\n")]
                last_code.execution_count = 1
            else:  # output fence with no preceding code cell
                cells.append(new_markdown_cell(f"```\n{body}\n```"))
        else:
            cells.append(new_markdown_cell(body))
    # Deterministic cell ids (content + position hash): regeneration
    # is a no-op unless a tutorial actually changed.
    import hashlib
    for i, cell in enumerate(cells):
        cell["id"] = hashlib.sha1(
            f"{i}:{cell.source}".encode()).hexdigest()[:8]
    nb = new_notebook(
        cells=cells,
        metadata={
            "kernelspec": {"display_name": "Python 3",
                           "language": "python", "name": "python3"},
            "language_info": {"name": "python"},
        },
    )
    if execute:
        if not executable:
            raise SystemExit(
                f"{md_path.name} has no <!-- nb-setup --> blocks; its "
                "code cells are fragments and cannot execute.")
        # Drop the pasted outputs, then run for real from the repo root.
        for cell in nb.cells:
            if cell.cell_type == "code":
                cell.outputs = []
                cell.execution_count = None
        from nbclient import NotebookClient

        client = NotebookClient(
            nb, timeout=600, kernel_name="python3",
            resources={"metadata": {
                "path": str(md_path.parent.parent.parent)}})
        client.execute()
    nbformat.validate(nb)
    out_path.write_text(nbformat.writes(nb) + "\n")


def main(argv=None):
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--execute", nargs="*", metavar="STEM",
                        default=None,
                        help="execute these tutorials (by md stem) with "
                             "nbclient instead of pasting captured "
                             "output; with no stems, executes every "
                             "tutorial that has nb-setup blocks")
    parser.add_argument("--out-dir", default=None,
                        help="write notebooks here instead of "
                             "docs/notebooks (use with --execute to "
                             "keep the committed outputs)")
    args = parser.parse_args(argv)

    root = pathlib.Path(__file__).parent
    out_dir = (pathlib.Path(args.out_dir) if args.out_dir
               else root / "notebooks")
    out_dir.mkdir(parents=True, exist_ok=True)
    for md in sorted((root / "tutorials").glob("*.md")):
        if args.execute is not None:
            wanted = not args.execute or md.stem in args.execute
            if args.execute and not wanted:
                continue
            if not args.execute and "<!-- nb-setup" not in md.read_text():
                continue
            target = out_dir / (md.stem + ".ipynb")
            convert(md, target, execute=True)
            print(f"executed {target}")
        else:
            target = out_dir / (md.stem + ".ipynb")
            convert(md, target)
            print(f"wrote {target.relative_to(root.parent)}")


if __name__ == "__main__":
    main()
