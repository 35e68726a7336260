"""One band's part of a sharded physics frame a call
(``make_plane_sharded_step``); aux is the frame's diagnostics, summed over
the bands and left on the card."""

IMAGE = False


def build(program):
    if program.mesh is None:
        raise ValueError("the sharded step runs on a band mesh: the configuration states no bands")
    from rust_particle_system_tpu_torch.parallel import make_plane_sharded_step

    step = make_plane_sharded_step(program.spec, program.mesh,
                                   rebin_variant=program.rebin_variant,
                                   fuse_tail=program.fuse_tail)
    return lambda ps: step(ps, program.params)
