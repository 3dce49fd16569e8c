"""setup_s: seconds from the process's start to the first timed call
(imports, CUDA context, the kernels' library, the DEM from the seed, the
set-up steps and one warm job)."""


def read(run):
    return run.setup_s
