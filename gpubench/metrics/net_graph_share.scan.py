"""Share of the network's calls begun in the traced part of the window that
replayed a CUDA graph, in %: of the main thread's outer ``mast3r.*`` spans
(``mast3r.encode``, ``.mono``, ``.asym``, ``.sym``), those whose attribute
``graph`` reads ``replay``. Nothing where no such span carries the
attribute (a program that runs the network eagerly only)."""

from gpubench import program

OUTER = ("mast3r.encode", "mast3r.mono", "mast3r.asym", "mast3r.sym")


def read(ctx):
    got = program.traced(ctx)
    if got is None:
        return None
    spans, lo, hi = got
    main = program.main_thread()
    modes = [(s.attrs or {}).get("graph") for name in OUTER
             for s in program.started(spans, name, lo, hi)
             if s.thread == main]
    if all(m is None for m in modes):
        return None
    return 100.0 * modes.count("replay") / len(modes)
