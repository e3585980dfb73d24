"""setup_s: seconds from the process start to the first timed frame
(loading, the scene build, the kernels built and compiled, the warm-up
frames)."""


def read(run):
    return run["setup_s"]
