"""Work placement across cards.

 - vertex.py : the scheduler's vertex (candidate-subset) axis
 - cells.py  : the cell axis of a sweep of whole simulations
"""
