"""Kernel wrappers of the port: each module holds a hand-written CUDA
kernel's wrapper and its plain torch version side by side.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain
version.

Every wrapper launches on PyTorch's current stream and reads no tensor
value on the host, so it can be captured in a CUDA graph
(solve/device_pcg.py); its outputs then come from the graph's memory
pool.  Each wrapper counts a launch in utils/logging.TIMERS where it
launches its kernel, and only there: every launch of an eager call, but
for a captured graph only the one recording at capture, since a replay
runs no Python.  The counters, by wrapper:

    blockrow.kernel, blockrow.kernel.<mode>   blockrow
    contract.kernel.R, contract.kernel.P      contract_R, contract_P
    midsmooth.kernel                          mid_chain
    midmv.kernel, midmv.kernel.<mode>         midmv
    mfree.kernel                              mfree_h, mfree_chain and
                                              mfree_point_h together
    mfree.kernel.<mode>                       mfree_h
    mfree.kernel.chain                        mfree_chain
    mfree.route.tiled, mfree.route.flat       mfree_h and mfree_chain
    smoother.kernel                           smoother_h
    stencil.kernel                            stencil_h
    symv.kernel                               symv
    vstencil.kernel, vstencil.kernel.<mode>   vstencil
    wavefront.kernel                          wavefront_smooth
    window.kernel.R, window.kernel.P          window_R, window_P

``<mode>`` is the pass's mode (spmv, residual, root; blockrow also
transpose; vstencil spmv, residual, chain).  ``blockrow.plain``,
``midmv.plain``, ``mfree.plain``, ``symv.plain`` and ``vstencil.plain``
count the calls that take the plain route instead.  Three counters are
not launch counts: ``midmv.packed_bytes`` adds the bytes (values and
index) of each compact mid packing when ``midmv.pack_mid`` builds it,
``symv.bytes`` the bytes of each lower-triangle packing when
``symv.pack_lower`` builds it, and ``vstencil.bytes`` the bytes of the
node-block values (ops/sparse.NodeBlock) when ``compile_hierarchy``
builds them."""
