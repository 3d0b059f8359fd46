"""BERT names over the ERNIE-family implementation (port of
``paddle_infer_tpu/models/bert.py``: the two architectures are the same
at this layer; the ``bert-base`` / ``bert-large`` presets live in
``ERNIE_PRESETS``)."""
from .ernie import ErnieConfig as BertConfig
from .ernie import ErnieForPretraining as BertForPretraining
from .ernie import (ErnieForSequenceClassification as
                    BertForSequenceClassification)
from .ernie import ErnieModel as BertModel

__all__ = ["BertConfig", "BertModel", "BertForPretraining",
           "BertForSequenceClassification"]
