"""One physics frame and its image a call: ``SPHFluid.step_and_render``
(``plane_frame``: the step, then K4's image of the end planes)."""

IMAGE = True


def build(program):
    return program.step_and_render
