"""Wrappers of the hand-written CUDA kernels (``csrc/*.cu``).

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors; each counts its launches in ``.launches``.

    K1  rebin.rebin_planes                  csrc/rebin.cu
    K7  rebin.rebin_planes_band             csrc/rebin.cu (K1's kernels on a band)
    K9  rebin.hole_fill_pass                csrc/rebin_pass.cu (rebin variants 4, 5)
    K12 rebin.rebin_compact                 csrc/rebin_compact.cu (rebin variants 2, 3)
    K2  sph.density_planes                  csrc/sph.cu
    K3  sph.force_planes_integrated         csrc/sph.cu
    K3b sph.force_planes                    csrc/sph.cu
    K4  render.splat_planes.raster_planes   csrc/splat_planes.cu (also K10)
    K5  plane_build.cell_planes_aos         csrc/plane_build.cu
    K6  sph.density_pairs, sph.force_pairs_integrated, sph.force_pairs
                                            csrc/sph.cu (pair-packed layout)
    K8  nbody.nbody_accel                   csrc/nbody.cu
    K13 toolchain_probe.dot_f32, dot_tf32, copy_ids, bf16_broadcast, bf16_outer
                                            csrc/toolchain_probe.cu (probes)
    K14 fast_forces.moments (a), fast_forces.evaluate (c)
                                            csrc/fast_forces.cu (the fast mode)
        fastmode_c128.a_dot (d), a_vpu (e), c_vpu (f)
                                            csrc/fastmode_c128.cu (its C=128 forms)
"""
