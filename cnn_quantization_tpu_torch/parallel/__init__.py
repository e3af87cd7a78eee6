from .mesh import Mesh, make_mesh, param_sharding, shard_params, shard_batch
from .eval_parallel import make_sharded_eval_step, evaluate_sharded
