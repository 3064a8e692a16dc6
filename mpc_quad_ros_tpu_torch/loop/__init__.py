from .batch import run_episode_batch_fused
from .episode import EpisodeCarry, EpisodeConfig, EpisodeOutput

__all__ = ["run_episode_batch_fused", "EpisodeCarry", "EpisodeConfig", "EpisodeOutput"]
