from hyperseg_torch.parallel.mesh import (make_mesh, make_mesh_for_batch, replicated,
                                          data_sharded, shard_batch, replicate_params)
from hyperseg_torch.parallel.spatial import spatial_parallel
