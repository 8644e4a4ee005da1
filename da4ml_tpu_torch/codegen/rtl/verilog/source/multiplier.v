// o = a * b (DAIS opcode 7), low WO bits of the full product.
module multiplier #(
    parameter WA = 8,
    parameter SA = 1,
    parameter WB = 8,
    parameter SB = 1,
    parameter WO = 16
) (
    input  [WA-1:0] a,
    input  [WB-1:0] b,
    output [WO-1:0] o
);
    localparam WI = WA + WB + 2;
    wire signed [WI-1:0] ea = SA ? $signed(a) : $signed({1'b0, a});
    wire signed [WI-1:0] eb = SB ? $signed(b) : $signed({1'b0, b});
    wire signed [WI-1:0] prod = ea * eb;
    assign o = prod[WO-1:0];
endmodule
