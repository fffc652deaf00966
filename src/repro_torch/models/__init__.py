from .spec import ModelSpec, MoeSpec, SsmSpec
from .layers import cross_entropy
from .model import SplittableModel
from .vgg import VggModel, VggSpec, build_model
from .convert import params_from_numpy, params_to_numpy
