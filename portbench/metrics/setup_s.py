"""setup_s: seconds from the process's start to the window's start:
loading the dataset, building the model and its graphs, loading or
building the CUDA kernels, and warming up every shape the window uses."""


def read(run):
    return run.setup_s
