"""mrays_s: width x height x the frames render() finished in the window
(the frame in flight at its close by the share of its time inside), over
the window's seconds, in millions of rays a second (the mesh cell's
BlockingRenderer loop)."""

from gbench import readers


def read(run):
    return readers.mrays_s(run)
