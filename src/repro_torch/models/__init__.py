"""The paper's DCN benchmark networks and the LM serving models."""
