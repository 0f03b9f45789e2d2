"""Crop → mesh prediction: proxy representation and the predict stage."""

from soccerplayershapepose_torch.pipeline.predict import (  # noqa: F401
    PredictOutput, build_predictor, predict_smpl)
