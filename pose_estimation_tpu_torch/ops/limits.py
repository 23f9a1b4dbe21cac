"""What the port's CUDA kernels take, and the check of a model
configuration against it before the first launch.

The JAX package runs every shape. The kernels take any batch, point count
and support count S, with these limits left:

  knn (csrc/knn.cu)        at most KNN_MAX_KK neighbours a search (the
                           point itself included in a self search): the
                           candidate lists and the rescan's sorted lists
                           are compiled sizes
  surface_multi (kernel 2) at most SURF_MAX_STREAMS streams and K <=
                           SURF_MAX_K (a tile's nd sits in shared memory)
  linear_multi (kernel 1)  O a multiple of 8, and S*O at most
                           LINEAR_MAX_ROW_BYTES of the table's dtype: pass
                           B gives each 16 bytes of a table row a thread,
                           512 threads a block
  aggregate (kernel 5)     D = 3 or 9, the JAX ConvLayer's point_dims

`check_config` holds a configuration, and the (S, O, dtype) of the layers
a model hands linear_multi, to these limits, and raises a ValueError that
names the limit and the config field. The serving and eval steps and the
trainer call it (serve.check_model) for a model on a card.
"""

from __future__ import annotations

import torch

KNN_MAX_KK = 32
SURF_MAX_STREAMS = 4
SURF_MAX_K = 128
LINEAR_MAX_ROW_BYTES = 512 * 16


def check_config(cfg, linear_layers=()) -> None:
    """Raise ValueError if `cfg`, or a layer of `linear_layers` ((S, O,
    dtype) of each layer whose aggregate goes to linear_multi), would give
    a kernel a shape it does not take."""
    g = cfg.module.gcn3d
    # self searches take neighbor_num + 1 (the point itself comes first);
    # the surface kernel's K is neighbor_num, inside its limit below this
    if g.neighbor_num + 1 > KNN_MAX_KK:
        raise ValueError(
            f"module.gcn3d.neighbor_num = {g.neighbor_num}: the KNN kernel "
            f"(csrc/knn.cu) takes at most {KNN_MAX_KK} neighbours a search, "
            f"the point itself included, so neighbor_num <= "
            f"{KNN_MAX_KK - 1}")
    for s, o, dtype in linear_layers:
        most = LINEAR_MAX_ROW_BYTES // (torch.finfo(dtype).bits // 8)
        if o % 8:
            raise ValueError(
                f"a ConvLayer of width {o}: the fused linear aggregate "
                f"(csrc/gcn.cu linear_agg_kernel) takes O a multiple of 8")
        if s * o > most:
            raise ValueError(
                f"module.gcn3d.support_num = {s}: the fused linear "
                f"aggregate (csrc/gcn.cu linear_agg_kernel) takes S*O <= "
                f"{most} in {dtype}, and a ConvLayer has O = {o}, so "
                f"support_num <= {most // o}")
