"""setup_s: from the process's start to the first timed frame: imports, the
kernel library's load (and its build in a checkout's first run), the
world's build, the replicate, the statics and the warm frames."""


def read(run):
    return run.setup_s
