"""Set-up: process start (the launcher's, on several cards) to the window's
opening: imports, the card's context, building or loading the port's
kernels, the weights and traffic made on the device, the compared first
calls and the warm-up. Host clock."""

UNIT = "s"


def read(r):
    return r.setup_s
