from . import ae, classifier, common, decoder, encoder, gan, vae
from .ae import AutoEncoderKL, AutoEncoderVQ
from .classifier import ImageClassifier, RRDBNet
from .gan import VanillaGenerator
from .vae import VQVAE, VanillaVAE
