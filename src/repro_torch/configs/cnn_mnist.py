"""The paper's CNN model (MNIST/FMNIST experiments, §V)."""
MODEL_KIND = "cnn"
CHANNELS = (16, 32)
