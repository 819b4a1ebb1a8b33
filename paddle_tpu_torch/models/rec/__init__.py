"""paddle_tpu_torch.models.rec: the book's recommender nets (chapter 5)."""
from .recommender import DeepFM, TwoTowerRecommender, rating_loss

__all__ = ["TwoTowerRecommender", "DeepFM", "rating_loss"]
