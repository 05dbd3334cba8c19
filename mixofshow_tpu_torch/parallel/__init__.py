from mixofshow_tpu_torch.parallel.mesh import (Mesh, all_max, all_sum,
                                               barrier, broadcast_object,
                                               close_mesh, make_mesh,
                                               reduce_grads, replicate_,
                                               shard_batch)

__all__ = ['Mesh', 'all_max', 'all_sum', 'barrier', 'broadcast_object',
           'close_mesh', 'make_mesh', 'reduce_grads', 'replicate_',
           'shard_batch']
