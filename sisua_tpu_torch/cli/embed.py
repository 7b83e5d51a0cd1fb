"""sisua-embed for the port: GMM probabilistic embedding of protein
counts (``label_threshold.main``)."""

from ..label_threshold import main

if __name__ == "__main__":
  main()
