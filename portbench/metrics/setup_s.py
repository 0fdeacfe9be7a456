"""setup_s: seconds from the process's start to the first timed step
(imports, kernel load or build, inputs, one warm step per input set)."""


def read(host: dict):
    return host["setup_s"]
