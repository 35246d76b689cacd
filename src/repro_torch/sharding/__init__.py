"""Work placement across cards.

 - vertex.py : the scheduler's vertex (candidate-subset) axis
"""
