from .synthetic import (
    SyntheticImageDataset,
    SyntheticLmDataset,
    make_cifar10_like,
    make_lm_stream,
    make_mnist_like,
)
from .partition import label_skew, partition_iid, partition_sort_and_shard
from .loader import FederatedLoader, image_loader, lm_loader
