"""The paper's DCN benchmark networks."""
