"""Build the documentation site: markdown -> static HTML.

The reference ships a Sphinx/ReadTheDocs site
(``/root/reference/docs/source/conf.py``, ``readthedocs.yml``); this
repo's canonical docs are markdown.  This builder renders them into a
browsable static site at ``docs/_site/`` with a sidebar navigation, a
generated API-reference page (autodoc off the package docstrings, which
carry the reference ``file:line`` citations), and rewritten
cross-document links -- no Sphinx/mkdocs dependency (neither is
installable in the build environment; the ``markdown`` package is).

Build:  ``make -C docs html``   (or ``python docs/build_site.py``)
Output: ``docs/_site/index.html``
"""

import html
import inspect
import importlib
import pathlib
import re
import shutil
import sys

import markdown

ROOT = pathlib.Path(__file__).parent
SITE = ROOT / "_site"

PAGES = [
    ("index", "../README.md", "Overview"),
    ("getting_started", "getting_started.md", "Getting started"),
    ("api", "api.md", "API guide"),
    ("models", "models.md", "Model physics"),
    ("performance", "performance.md", "Performance"),
    ("migration", "migration.md", "Migrating from RRMPG"),
    ("operations", "operations.md", "Operations"),
]

API_MODULES = [
    "rrmpg_jax",
    "rrmpg_jax.models",
    "rrmpg_jax.models.basemodel",
    "rrmpg_jax.models.states",
    "rrmpg_jax.ops",
    "rrmpg_jax.ops.pallas_gr4j",
    "rrmpg_jax.ops.pallas_snow",
    "rrmpg_jax.ops.pallas_hbv",
    "rrmpg_jax.ops.fused",
    "rrmpg_jax.parallel",
    "rrmpg_jax.parallel.mesh",
    "rrmpg_jax.parallel.ensemble",
    "rrmpg_jax.parallel.regional",
    "rrmpg_jax.parallel.distributed",
    "rrmpg_jax.tools",
    "rrmpg_jax.tools.monte_carlo",
    "rrmpg_jax.tools.calibration",
    "rrmpg_jax.tools.sce",
    "rrmpg_jax.tools.moo",
    "rrmpg_jax.tools.mcmc",
    "rrmpg_jax.tools.sensitivity",
    "rrmpg_jax.tools.uncertainty",
    "rrmpg_jax.tools.assimilation",
    "rrmpg_jax.utils.metrics",
    "rrmpg_jax.utils.signatures",
    "rrmpg_jax.utils.array_checks",
    "rrmpg_jax.utils.plot_utils",
    "rrmpg_jax.data.camelsloader",
    "rrmpg_jax.config",
]

TEMPLATE = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>{title} — rrmpg-jax</title>
<style>
:root {{ --fg: #1c1e21; --muted: #5f6368; --accent: #0b57d0;
         --bg: #ffffff; --side: #f6f8fa; --border: #d0d7de; }}
* {{ box-sizing: border-box; }}
body {{ margin: 0; color: var(--fg); background: var(--bg);
       font: 16px/1.6 system-ui, -apple-system, "Segoe UI", sans-serif; }}
nav {{ position: fixed; top: 0; bottom: 0; left: 0; width: 240px;
      overflow-y: auto; background: var(--side);
      border-right: 1px solid var(--border); padding: 1rem; }}
nav h1 {{ font-size: 1.1rem; margin: 0 0 1rem; }}
nav a {{ display: block; color: var(--fg); text-decoration: none;
        padding: .25rem .5rem; border-radius: 6px; font-size: .95rem; }}
nav a:hover {{ background: #eaeef2; }}
nav a.current {{ color: var(--accent); font-weight: 600; }}
nav .sec {{ margin: 1rem 0 .25rem; font-size: .75rem; text-transform:
           uppercase; letter-spacing: .06em; color: var(--muted); }}
main {{ margin-left: 240px; padding: 2rem 3rem; max-width: 60rem; }}
code {{ background: #f0f2f5; padding: .1em .35em; border-radius: 4px;
       font-size: .9em; }}
pre {{ background: #f6f8fa; border: 1px solid var(--border);
      border-radius: 8px; padding: 1rem; overflow-x: auto; }}
pre code {{ background: none; padding: 0; }}
table {{ border-collapse: collapse; display: block; overflow-x: auto;
        margin: 1rem 0; }}
th, td {{ border: 1px solid var(--border); padding: .4rem .7rem;
         text-align: left; font-size: .93rem; }}
th {{ background: var(--side); }}
h1, h2, h3 {{ line-height: 1.25; }}
h2 {{ border-bottom: 1px solid var(--border); padding-bottom: .3rem;
     margin-top: 2.2rem; }}
a {{ color: var(--accent); }}
blockquote {{ border-left: 3px solid var(--border); margin-left: 0;
             padding-left: 1rem; color: var(--muted); }}
.docstring {{ border: 1px solid var(--border); border-radius: 8px;
             padding: .8rem 1rem; margin: .8rem 0; }}
.docstring h4 {{ margin: .1rem 0 .5rem; font-family: ui-monospace,
                monospace; font-size: .95rem; }}
.docstring pre {{ white-space: pre-wrap; background: none; border: 0;
                 padding: 0; margin: 0; color: var(--muted);
                 font: .85rem/1.5 ui-monospace, monospace; }}
</style>
</head>
<body>
<nav>
<h1>rrmpg-jax</h1>
{nav}
</nav>
<main>
{body}
</main>
</body>
</html>
"""


def _nav(current):
    items = []
    for slug, _, title in PAGES:
        cls = ' class="current"' if slug == current else ""
        items.append(f'<a href="{slug}.html"{cls}>{title}</a>')
    items.append('<div class="sec">Reference</div>')
    cls = ' class="current"' if current == "reference" else ""
    items.append(f'<a href="reference.html"{cls}>API reference '
                 f'(autodoc)</a>')
    items.append('<div class="sec">Tutorials</div>')
    for md in sorted((ROOT / "tutorials").glob("*.md")):
        slug = f"tutorial_{md.stem}"
        cls = ' class="current"' if slug == current else ""
        title = md.read_text().splitlines()[0].lstrip("# ").replace(
            "Tutorial: ", "")
        items.append(f'<a href="{slug}.html"{cls}>{html.escape(title)}'
                     f'</a>')
    return "\n".join(items)


_LINK = re.compile(r'href="([^"]+)"')


def _rewrite_links(body):
    """Point intra-repo markdown links at their rendered pages."""
    def sub(m):
        target = m.group(1)
        if target.startswith(("http:", "https:", "#", "mailto:")):
            return m.group(0)
        name = target.split("#")[0]
        frag = target[len(name):]
        stem = pathlib.PurePosixPath(name).name
        if stem.endswith(".md"):
            stem = stem[:-3]
            if "tutorials/" in name:
                return f'href="tutorial_{stem}.html{frag}"'
            for slug, src, _ in PAGES:
                if pathlib.PurePosixPath(src).name == stem + ".md":
                    return f'href="{slug}.html{frag}"'
            return f'href="{stem}.html{frag}"'
        # Source files: link into the repository layout one level up.
        return m.group(0)
    return _LINK.sub(sub, body)


def _render_md(text):
    md = markdown.Markdown(
        extensions=["tables", "fenced_code", "toc", "sane_lists"])
    return md.convert(text)


def _page(slug, title, body_html):
    return TEMPLATE.format(title=html.escape(title), nav=_nav(slug),
                           body=_rewrite_links(body_html))


def _autodoc_module(name):
    mod = importlib.import_module(name)
    parts = [f'<h2 id="{name}"><code>{name}</code></h2>']
    if mod.__doc__:
        parts.append(
            f'<blockquote><pre>{html.escape(inspect.cleandoc(mod.__doc__))}'
            f'</pre></blockquote>')
    for attr, obj in sorted(vars(mod).items()):
        if attr.startswith("_"):
            continue
        if getattr(obj, "__module__", None) != name:
            continue  # only symbols defined here (not re-exports)
        if not (inspect.isfunction(obj) or inspect.isclass(obj)):
            continue
        doc = inspect.getdoc(obj) or ""
        try:
            sig = str(inspect.signature(obj))
        except (ValueError, TypeError):
            sig = "(...)"
        kind = "class" if inspect.isclass(obj) else "def"
        parts.append(
            f'<div class="docstring"><h4>{kind} {attr}'
            f'{html.escape(sig)}</h4>'
            f'<pre>{html.escape(doc)}</pre></div>')
    return "\n".join(parts)


def main():
    if SITE.exists():
        shutil.rmtree(SITE)
    SITE.mkdir(parents=True)

    for slug, src, title in PAGES:
        text = (ROOT / src).resolve().read_text()
        (SITE / f"{slug}.html").write_text(
            _page(slug, title, _render_md(text)))
        print(f"wrote docs/_site/{slug}.html")

    for md in sorted((ROOT / "tutorials").glob("*.md")):
        slug = f"tutorial_{md.stem}"
        # Strip hidden nb-setup comment blocks from the rendered page.
        text = re.sub(r"<!--\s*nb-setup.*?-->", "", md.read_text(),
                      flags=re.S)
        title = text.splitlines()[0].lstrip("# ")
        (SITE / f"{slug}.html").write_text(
            _page(slug, title, _render_md(text)))
        print(f"wrote docs/_site/{slug}.html")

    sys.path.insert(0, str(ROOT.parent))
    body = ["<h1>API reference</h1>",
            "<p>Generated from the package docstrings (which cite the "
            "reference implementation as <code>rrmpg/…:line</code> for "
            "parity checks). Rebuild with <code>make -C docs "
            "html</code>.</p>"]
    for name in API_MODULES:
        body.append(_autodoc_module(name))
    (SITE / "reference.html").write_text(
        _page("reference", "API reference", "\n".join(body)))
    print("wrote docs/_site/reference.html")


if __name__ == "__main__":
    main()
