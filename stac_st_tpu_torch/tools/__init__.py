"""Scripts of the flagship quality run: ``flagship_corpus`` builds the corpus, ``eval_flagship`` scores a trained experiment."""
