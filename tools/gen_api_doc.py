"""Generate docs/API.md: a compact public-API index (module -> public
functions/classes with their signature and first docstring line).

Usage: python tools/gen_api_doc.py   (rewrites docs/API.md)
"""

import importlib
import inspect
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax

jax.config.update("jax_platforms", "cpu")

MODULES = [
    "spinrelax_tpu.constants",
    "spinrelax_tpu.core.quaternion",
    "spinrelax_tpu.core.geometry",
    "spinrelax_tpu.core.stats",
    "spinrelax_tpu.models.ctmodel",
    "spinrelax_tpu.models.diffusion",
    "spinrelax_tpu.models.experiments",
    "spinrelax_tpu.ops.autocorr",
    "spinrelax_tpu.ops.jomega",
    "spinrelax_tpu.ops.relaxation",
    "spinrelax_tpu.ops.observables",
    "spinrelax_tpu.ops.dq",
    "spinrelax_tpu.ops.orient",
    "spinrelax_tpu.ops.pbc",
    "spinrelax_tpu.ops.ired",
    "spinrelax_tpu.fit.lm",
    "spinrelax_tpu.fit.expfit",
    "spinrelax_tpu.fit.legacy_expfit",
    "spinrelax_tpu.fit.globalfit",
    "spinrelax_tpu.fit.legacyfit",
    "spinrelax_tpu.fit.scalar",
    "spinrelax_tpu.io.trajectory",
    "spinrelax_tpu.io.pdb",
    "spinrelax_tpu.io.colvar",
    "spinrelax_tpu.io.xvg",
    "spinrelax_tpu.io.fittedct",
    "spinrelax_tpu.io.experiments",
    "spinrelax_tpu.io.vectors",
    "spinrelax_tpu.io.dx",
    "spinrelax_tpu.io.bmrb",
    "spinrelax_tpu.io.nmrstar",
    "spinrelax_tpu.io.hydronmr",
    "spinrelax_tpu.io.gmx",
    "spinrelax_tpu.io.native",
    "spinrelax_tpu.io.gro",
    "spinrelax_tpu.io.dcd",
    "spinrelax_tpu.io.amber",
    "spinrelax_tpu.io.xyz",
    "spinrelax_tpu.io.ndx",
    "spinrelax_tpu.io.psf",
    "spinrelax_tpu.io.prmtop",
    "spinrelax_tpu.io.zopen",
    "spinrelax_tpu.parallel.mesh",
    "spinrelax_tpu.parallel.pipeline",
    "spinrelax_tpu.parallel.streamed",
    "spinrelax_tpu.parallel.ingest",
    "spinrelax_tpu.parallel.fit",
    "spinrelax_tpu.pipeline.config",
    "spinrelax_tpu.pipeline.stages",
    "spinrelax_tpu.pipeline.runall",
    "spinrelax_tpu.pipeline.corrections",
    "spinrelax_tpu.pipeline.manifest",
    "spinrelax_tpu.utils.profiling",
    "spinrelax_tpu.utils.compile_cache",
]


def first_line(doc):
    if not doc:
        return ""
    return doc.strip().splitlines()[0].rstrip(".")


def sig_of(obj):
    try:
        s = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"
    return s if len(s) <= 90 else s[:87] + "...)"


def main():
    out = [
        "# API index",
        "",
        "Public surface of every module (generated by "
        "`tools/gen_api_doc.py`; regenerate after API changes).  The CLI "
        "surface is documented in docs/MIGRATION.md; deeper design in "
        "docs/ARCHITECTURE.md.",
        "",
    ]
    for name in MODULES:
        mod = importlib.import_module(name)
        out.append(f"## {name}")
        head = first_line(mod.__doc__)
        if head:
            out.append(f"*{head}.*")
        out.append("")
        rows = []
        for attr in sorted(dir(mod)):
            if attr.startswith("_"):
                continue
            obj = getattr(mod, attr)
            if inspect.ismodule(obj):
                continue
            owner = getattr(obj, "__module__", None)
            if owner != name:
                continue
            if inspect.isclass(obj):
                rows.append(f"- **class {attr}** — {first_line(obj.__doc__)}")
            elif callable(obj):
                rows.append(
                    f"- `{attr}{sig_of(obj)}` — {first_line(obj.__doc__)}"
                )
        out.extend(rows or ["- (constants only)"])
        out.append("")
    with open("docs/API.md", "w") as fp:
        fp.write("\n".join(out) + "\n")
    print(f"wrote docs/API.md ({len(out)} lines, {len(MODULES)} modules)")


if __name__ == "__main__":
    main()
