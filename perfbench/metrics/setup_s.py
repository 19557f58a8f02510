"""Set-up time: from the benchmark's process start to the window's start
(imports, the kernel's build where there is none yet, the model's own
set-up and its first step, the warm-up)."""


def read(rec):
    return rec.window.setup_s
