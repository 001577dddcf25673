"""Wall seconds of the fast-mean server's precompute (the search over
every training point, the neighbourhoods' kernel matrices and their
solves, to finished coefficients), as the server counts them in
``FastServer.precompute``; nothing where the server keeps no such count."""


def read(run):
    server = getattr(run.entry, "server", None)
    precompute = getattr(server, "precompute", None)
    if not precompute:
        return None
    return float(precompute["seconds"])
