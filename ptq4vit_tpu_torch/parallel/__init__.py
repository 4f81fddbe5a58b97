from .launch import run_from_env, spawn  # noqa: F401
from .mesh import (Evaluator, make_mesh, replicate, shard_batch,  # noqa: F401
                   shard_params, test_classification)
from .serve import ServingEngine  # noqa: F401
