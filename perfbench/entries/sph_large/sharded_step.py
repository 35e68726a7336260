"""The sharded step, as ``entries/sph/sharded_step.py`` makes it: one band's
part of a sharded physics frame a call; aux is the frame's diagnostics,
summed over the bands and left on the card."""

from pathlib import Path

from harness import spec

_SPH = spec.entry("sph", "sharded_step", Path(__file__).resolve().parents[2])
IMAGE = _SPH.IMAGE
build = _SPH.build
