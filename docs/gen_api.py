"""Generate docs/api.md — an API index of every public export.

The reference ships 44 generated .Rd man pages; this is the analog:
one table row per export in ``ccfindr_tpu.__all__`` (signature +
docstring summary), grouped by module, plus the container's public
attributes.  Regenerate after changing the API:

    python docs/gen_api.py          # rewrites docs/api.md
    python docs/gen_api.py -        # prints to stdout

tests/test_docs_workflow.py fails when the file is stale.
"""

import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import ccfindr_tpu as cf  # noqa: E402

GROUPS = [
    ("Container", "container",
     "The `SCSet` container (reference: the `scNMFSet` S4 class, "
     "R/scNMF_class.R)."),
    ("I/O", "io",
     "10x / MatrixMarket ingestion and export (reference: "
     "R/utils.R read_10x/write_10x)."),
    ("Quality control", "qc",
     "Cell / gene filtering and normalization (reference: R/utils.R)."),
    ("Simulation", "simulate",
     "Synthetic data generators (reference: R/utils.R "
     "simulate_data/simulate_whx)."),
    ("Factorization drivers", "drivers",
     "The two inference paths (reference: R/bayesian.R vb_factorize, "
     "R/factorize.R factorize)."),
    ("Model selection", "select",
     "Evidence-based rank selection and hard clustering (reference: "
     "R/utils2.R, R/utils.R cluster_id)."),
    ("Interpretation", "interpret",
     "Metagenes and factor-matrix visualization (reference: "
     "R/utils.R, R/utils2.R)."),
    ("Cluster tree", "tree",
     "Rank-hierarchy cluster tree (reference: R/tree.R)."),
    ("GSEA cell typing", "gsea",
     "Marker-gene-set enrichment (reference: R/gsea.R)."),
    ("Parallelism", "parallel",
     "Device meshes and multi-process initialization (reference "
     "analog: Rmpi restart distribution)."),
    ("Checkpointing", "checkpoint",
     "Result persistence and resume (an addition to the reference)."),
]


def _sig(obj):
    try:
        s = str(inspect.signature(obj))
    except (TypeError, ValueError):
        return ""
    return s if len(s) <= 76 else s[:73] + "...)"


def _summary(obj):
    doc = inspect.getdoc(obj) or ""
    first = doc.split("\n\n")[0].replace("\n", " ").strip()
    return first


def generate():
    byname = {}
    for name in cf.__all__:
        obj = getattr(cf, name)
        mod = (getattr(obj, "__module__", "") or "").split(".")[-1]
        byname.setdefault(mod, []).append((name, obj))

    out = ["# ccfindr_tpu API index", "",
           f"{len(cf.__all__)} public exports (generated by "
           "`docs/gen_api.py` — do not edit by hand).  Reference "
           "parity: every export of the reference's NAMESPACE:3-51 "
           "has an equivalent here; `file:line` pointers to the "
           "reference live in each docstring.", ""]
    seen = set()
    emitted = {}                       # id(obj) -> first export name
    for title, mod, blurb in GROUPS:
        entries = byname.get(mod, [])
        if not entries:
            continue
        out += [f"## {title}", "", blurb, ""]
        for name, obj in entries:
            seen.add(name)
            if id(obj) in emitted:
                out += [f"### `{name}`", "",
                        f"Alias of `{emitted[id(obj)]}` (reference-"
                        "compatible name).", ""]
                continue
            emitted[id(obj)] = name
            if inspect.isclass(obj):
                out.append(f"### `{name}`")
                out += ["", _summary(obj), ""]
                methods = [(n, m) for n, m in vars(obj).items()
                           if not n.startswith("_")
                           and (callable(m) or isinstance(m, property))]
                for n, meth in methods:
                    if isinstance(meth, property):
                        out.append(f"- `.{n}` — "
                                   f"{_summary(meth.fget) or 'property'}")
                    else:
                        out.append(f"- `.{n}{_sig(meth)}` — "
                                   f"{_summary(meth)}")
                out.append("")
            else:
                out.append(f"### `{name}{_sig(obj)}`")
                out += ["", _summary(obj), ""]
    rest = [n for n in cf.__all__ if n not in seen]
    if rest:
        out += ["## Aliases and other exports", ""]
        for name in rest:
            obj = getattr(cf, name)
            if id(obj) in emitted:
                out += [f"### `{name}`", "",
                        f"Alias of `{emitted[id(obj)]}` (reference-"
                        "compatible name).", ""]
                continue
            emitted[id(obj)] = name
            out.append(f"### `{name}{_sig(obj)}`")
            out += ["", _summary(obj), ""]
    return "\n".join(out) + "\n"


if __name__ == "__main__":
    text = generate()
    if "-" in sys.argv[1:]:
        sys.stdout.write(text)
    else:
        path = os.path.join(os.path.dirname(__file__), "api.md")
        with open(path, "w") as f:
            f.write(text)
        print(f"wrote {path} ({len(text.splitlines())} lines)")
