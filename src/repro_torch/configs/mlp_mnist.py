"""The paper's MLP model (MNIST/FMNIST experiments, §V)."""
MODEL_KIND = "mlp"
HIDDEN = 128
