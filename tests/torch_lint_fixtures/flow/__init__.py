"""Flow-pass fixture package (torch): effects hidden behind call hops.

Analyzed by flow.analyze_paths in tests. Every effect site a flow rule
must report carries an expect marker naming the rule on its line; the
tests hold the pass's findings to exactly those, and assert on the
chains.
"""
