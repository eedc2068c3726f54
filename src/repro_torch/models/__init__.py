"""The paper's MLP and CNN classifiers."""
