from .batch import run_episode_batch, run_episode_batch_fused, tracking_rmse_masked
from .episode import (EpisodeCarry, EpisodeConfig, EpisodeOutput, make_episode_fn, run_episode,
                      tracking_rmse)

__all__ = ["run_episode_batch", "run_episode_batch_fused", "tracking_rmse_masked", "EpisodeCarry",
           "EpisodeConfig", "EpisodeOutput", "make_episode_fn", "run_episode", "tracking_rmse"]
