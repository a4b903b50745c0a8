from .networks import ActorCritic, ActorCriticRecurrent
from .ppo import (
    PPOConfig,
    RolloutBatch,
    TrainState,
    compute_gae,
    init_train_state,
    make_learn_iteration,
    make_learn_iteration_sharded,
    ppo_update,
    rollout,
    rollout_sharded,
)
from .runner import CheckpointManager, OnPolicyRunner

__all__ = ["ActorCritic", "ActorCriticRecurrent", "PPOConfig",
           "RolloutBatch", "TrainState", "compute_gae", "init_train_state",
           "make_learn_iteration", "make_learn_iteration_sharded",
           "ppo_update", "rollout", "rollout_sharded", "CheckpointManager",
           "OnPolicyRunner"]
