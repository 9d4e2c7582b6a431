"""The paper's experiments on the port: Table 3, Figures 1-2 and Appendix
B.1 (``python -m repro_torch.paper``)."""
