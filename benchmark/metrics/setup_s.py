"""setup_s: seconds from the process's start to the end of the warm-up:
imports, the CUDA context, the kernels' library, the inputs, the warm
request."""


def read(data):
    return data.setup_s
