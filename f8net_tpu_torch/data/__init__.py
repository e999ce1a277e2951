from .pipeline import (
    ImageFolderDataset,
    SyntheticDataset,
    Loader,
    train_transform,
    eval_transform,
    IMAGENET_MEAN,
    IMAGENET_STD,
)
