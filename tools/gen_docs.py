"""Generate API reference docs from docstrings into docs/api/.

The reference ships a Doxygen target (`make doc`, its Makefile:183-185,
doc/Doxyfile); this is the equivalent here: one markdown
page per module with class/function signatures and docstrings, plus an
index.  Stdlib-only (no pdoc/sphinx in this environment).

  python tools/gen_docs.py          # writes docs/api/*.md
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "docs", "api")
sys.path.insert(0, ROOT)

PKG = "lut_ldpc_tpu"


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj, indent: str = "") -> str:
    d = inspect.getdoc(obj)
    if not d:
        return ""
    return "\n".join(indent + ln for ln in d.splitlines())


def module_page(mod) -> str:
    lines = [f"# `{mod.__name__}`", ""]
    if mod.__doc__:
        lines += [inspect.cleandoc(mod.__doc__), ""]
    pub = getattr(mod, "__all__", None)
    members = inspect.getmembers(mod)
    for name, obj in members:
        if name.startswith("_"):
            continue
        if pub is not None and name not in pub:
            continue
        if getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            lines += [f"## class `{name}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
            for mname, meth in inspect.getmembers(obj):
                if mname.startswith("_") or not (
                    inspect.isfunction(meth) or isinstance(
                        meth, (property, classmethod, staticmethod))
                ):
                    continue
                f = meth.fget if isinstance(meth, property) else meth
                f = getattr(f, "__func__", f)
                if not callable(f):
                    continue
                kind = "property " if isinstance(meth, property) else ""
                lines += [f"### {kind}`{name}.{mname}{_sig(f)}`", ""]
                if _doc(f):
                    lines += [_doc(f), ""]
        elif inspect.isfunction(obj):
            lines += [f"## `{name}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
    return "\n".join(lines) + "\n"


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    # force CPU so importing decoder modules never touches the chip
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

    pkg = importlib.import_module(PKG)
    names = [PKG]
    for m in pkgutil.walk_packages(pkg.__path__, prefix=PKG + "."):
        names.append(m.name)
    index = ["# lut_ldpc_tpu API reference", "",
             "Generated by `python tools/gen_docs.py` from module "
             "docstrings (the reference's `make doc` equivalent).", ""]
    for name in sorted(names):
        try:
            mod = importlib.import_module(name)
        except Exception as e:  # CLI mains etc. must import clean; report
            print(f"SKIP {name}: {e}", file=sys.stderr)
            continue
        fn = name.replace(".", "_") + ".md"
        with open(os.path.join(OUT, fn), "w") as f:
            f.write(module_page(mod))
        first = (inspect.cleandoc(mod.__doc__).splitlines()[0]
                 if mod.__doc__ else "")
        index.append(f"- [`{name}`]({fn}) — {first}")
    with open(os.path.join(OUT, "index.md"), "w") as f:
        f.write("\n".join(index) + "\n")
    print(f"wrote {len(names)} module pages to {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
