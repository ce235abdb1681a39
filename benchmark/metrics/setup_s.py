"""setup_s: from the harness's first statement to the end of the warm-up:
library load, world rendering, driver construction, warm-up and graph
capture. The idle wait before the window (the traffic's ``settle_s``) is
left out: a fixed floor would hide work moved into set-up."""


def read(run):
    return run.setup_s
