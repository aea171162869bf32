"""Share of the traced part of the window inside the backend's retrieval
update (the program's ``retrieval.update`` spans: the wait for the device
half and the host's inverted-file search and add), in %."""

from gpubench import program


def read(ctx):
    return program.share(ctx, lambda n: n == "retrieval.update")
