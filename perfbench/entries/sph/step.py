"""One physics frame a call, no image: ``SPHFluid.step`` (``plane_step``),
with the configuration's rebin variant and tail."""

IMAGE = False


def build(program):
    return lambda ps: (program.step(ps), None)
