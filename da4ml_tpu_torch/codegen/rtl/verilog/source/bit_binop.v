// Bitwise binary op (DAIS opcode 10): o = (+/-a << SHA) OP (+/-b << SHB)
// with OP in {AND=0, OR=1, XOR=2}, computed over WO-bit two's complement.
module bit_binop #(
    parameter WA = 8,
    parameter SA = 1,
    parameter WB = 8,
    parameter SB = 1,
    parameter NEG_A = 0,
    parameter NEG_B = 0,
    parameter SHA = 0,
    parameter SHB = 0,
    parameter OP = 0,
    parameter WO = 8
) (
    input  [WA-1:0] a,
    input  [WB-1:0] b,
    output [WO-1:0] o
);
    localparam WI = (WA + SHA > WB + SHB ? WA + SHA : WB + SHB) + 2;
    wire signed [WI-1:0] ea0 = SA ? $signed(a) : $signed({1'b0, a});
    wire signed [WI-1:0] eb0 = SB ? $signed(b) : $signed({1'b0, b});
    wire signed [WI-1:0] ea = (NEG_A ? -ea0 : ea0) <<< SHA;
    wire signed [WI-1:0] eb = (NEG_B ? -eb0 : eb0) <<< SHB;
    wire signed [WI-1:0] r = OP == 0 ? (ea & eb) : OP == 1 ? (ea | eb) : (ea ^ eb);
    assign o = r[WO-1:0];
endmodule
